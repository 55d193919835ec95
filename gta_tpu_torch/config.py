"""Typed configuration with reference-YAML ingestion.

The port's own copy of the parts of `gta_tpu/config.py` the serving path
needs: `load_config(path)` maps the reference's nested-dict YAML schema onto
frozen dataclasses with the same field names, defaults and parse rules, so a
run config means the same thing to both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import yaml

# Fixed group ordering of channel slices inside a head (reference gta.py:115).
GROUP_ORDER = ("triv", "se3", "so3", "so2", "t2")


@dataclasses.dataclass(frozen=True)
class FDims:
    """Per-head channel budget for each geometric type."""

    triv: int = 0
    se3: int = 0
    so3: int = 0
    so2: int = 0
    t2: int = 0

    @property
    def total(self) -> int:
        return self.triv + self.se3 + self.so3 + self.so2 + self.t2

    def slices(self) -> Tuple[Tuple[str, int, int], ...]:
        """(name, start, end) for every active group, in GROUP_ORDER."""
        out = []
        cur = 0
        for name in GROUP_ORDER:
            d = getattr(self, name)
            if d > 0:
                out.append((name, cur, cur + d))
            cur += d
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class GTAArgs:
    """Static arguments of the GTA attention method (reference configs'
    model.args.*.attn_args.method.args block)."""

    f_dims: FDims = FDims()
    so2: int = 0  # number of SO(2) frequencies
    max_freq_h: float = 1.0
    max_freq_w: float = 1.0
    shared_freqs: bool = False
    so3: int = 0  # max Wigner-D degree (degrees 1..so3 are used)
    v_transform: bool = True
    euclid_sim: bool = False
    elementwise_mul: bool = False
    recompute_so2: bool = False
    ray_to_se3: bool = False
    zeroout_so3: bool = False
    id_so3: bool = False
    use_bias: bool = False

    @property
    def n_so2_rotors(self) -> int:
        return 2 * self.so2  # 2 coordinate dims x so2 freqs

    def validate(self):
        fd = self.f_dims
        if fd.so2 > 0 and fd.so2 != 2 * self.n_so2_rotors:
            raise ValueError(
                f"f_dims.so2 ({fd.so2}) must equal 2*2*so2_freqs ({2 * self.n_so2_rotors})"
            )
        if fd.se3 > 0 and not self.euclid_sim and fd.se3 % 4:
            raise ValueError("f_dims.se3 must be divisible by 4")
        if fd.se3 > 0 and self.euclid_sim and fd.se3 % 3:
            raise ValueError("euclid f_dims.se3 must be divisible by 3")
        if fd.so3 > 0 and self.so3 < 1:
            raise ValueError("so3 degree count must be >= 1 when f_dims.so3 > 0")
        if fd.t2 > 0 and fd.t2 % 3:
            raise ValueError("f_dims.t2 must be divisible by 3")


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    """Attention-method configuration (reference attn_args block): the
    JAX package's fields less its runtime switches (flash, fused, ring),
    which the port replaces by one rule (`flash_eligible`, models/layers.py)."""

    method: str = "gta"  # '', 'gta', 'ape', 'mln', 'repast', 'gbt', 'frustum_posemb', 'invatt_directsum'
    gta: GTAArgs = GTAArgs()
    softmax: str = "standard"  # 'standard' | 'adjustable'
    use_bias: bool = False
    # repast
    q_emb_dim: int = 0
    k_emb_dim: int = 0
    v_bias: bool = False
    enable_scale: bool = False
    # frustum_posemb
    frustum_D: int = 0
    frustum_dmin: float = 0.1
    frustum_dmax: float = 10.0
    frustum_normalize: bool = False
    frustum_fourier: bool = False
    frustum_freqs: int = 15
    # rpe (learned-rep "invatt_directsum")
    rpe: bool = False
    rpe_so2: int = 0

    @property
    def is_gta(self) -> bool:
        return self.method == "gta"

    @property
    def flash_eligible(self) -> bool:
        """Whether the JAX package takes its flash kernels for this non-GTA
        method on a TPU (gta_tpu/config.py:137-144): plain dot-product
        softmax only. GTA routes by its own rule (models/layers.Attention)."""
        return self.softmax == "standard" and self.method in ("", "ape", "mln", "frustum_posemb")


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    dim: int = 768
    attdim: int = 768
    num_conv_blocks: int = 3
    num_att_blocks: int = 5
    pos_start_octave: int = 0
    heads: int = 12
    dropout: float = 0.0
    emb: Optional[str] = "ray"  # 'ray' | 'planar' | 'camera_planar' | None
    attn: AttnConfig = AttnConfig()


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    dim: int = 180
    num_att_blocks: int = 2
    pos_start_octave: int = 0
    z_dim: int = 768
    heads: int = 12
    rmlp_dim: int = 1536
    act: str = "lrelu"
    dropout: float = 0.0
    dim_head: Optional[int] = None  # default z_dim // heads
    mlp_dim: Optional[int] = None  # default z_dim * 2
    emb: Optional[str] = "ray"  # 'ray' | 'const' | 'planar' | 'camera_planar'
    sigmoid: bool = True
    return_last_attmap: bool = False
    scale_h: float = 1.0
    scale_w: float = 1.0
    attn: AttnConfig = AttnConfig()

    @property
    def head_dim(self) -> int:
        return self.dim_head if self.dim_head is not None else self.z_dim // self.heads

    @property
    def ff_dim(self) -> int:
        return self.mlp_dim if self.mlp_dim is not None else self.z_dim * 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    model_type: str = "tsrt"  # 'srt' | 'tsrt'
    encoder: EncoderConfig = EncoderConfig()
    decoder: DecoderConfig = DecoderConfig()
    ftl: bool = False


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic"  # 'clevrtr' | 'msn' | 'synthetic'
    path: str = ""
    num_points: int = 2560
    downsample: int = 0
    downsample_input_coord: int = 3
    num_input_views: int = 2
    num_target_views: int = 3
    num_views: int = 5
    overlap: bool = False
    reconstruction: bool = False
    camera_noise: float = 0.0
    kubric_basis: bool = False
    image_coord: bool = False
    # default True for python-constructed configs; the YAML parser defaults
    # to False (reference dataset default) when the key is absent
    return_transform: bool = True
    canonical_view: bool = True
    avoid_zerocamorg: bool = False
    height: int = 240
    width: int = 320
    shuffle: Optional[int] = None
    return_org_rays: bool = False
    return_org_images: bool = False
    downsample_target: int = 0
    load_depth: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32
    lr: float = 1e-4
    lr_warmup: int = 2500
    decay_it: int = 4000000
    decay_rate: float = 0.16
    max_it: int = 1000000
    mixed_prec: bool = False
    loss_scale: bool = False
    noadamW: bool = False
    weight_decay: float = 0.01
    num_workers: int = 1
    print_every: int = 100
    validate_every: int = 10000
    visualize_every: int = 10000
    checkpoint_every: int = 1000
    backup_every: int = 25000
    model_selection_metric: str = "psnr"
    model_selection_mode: str = "maximize"
    grad_accum: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig = DataConfig()
    model: ModelConfig = ModelConfig()
    training: TrainConfig = TrainConfig()
    seed: int = 0


# ---------------------------------------------------------------------------
# Reference-YAML ingestion
# ---------------------------------------------------------------------------


def _parse_attn(attn_args: dict) -> AttnConfig:
    if not attn_args:
        return AttnConfig(method="")
    method = attn_args.get("method", {})
    name = method.get("name", "") or ""
    args = method.get("args", {}) or {}
    softmax = "adjustable" if attn_args.get("softmax") == "adjustable" else "standard"

    gta = GTAArgs()
    if name == "gta":
        fd = args.get("f_dims", {}) or {}
        gta = GTAArgs(
            f_dims=FDims(**{k: int(v) for k, v in fd.items()}),
            so2=int(args.get("so2", 0)),
            max_freq_h=float(args.get("max_freq_h", 1.0)),
            max_freq_w=float(args.get("max_freq_w", 1.0)),
            shared_freqs=bool(args.get("shared_freqs", False)),
            so3=int(args.get("so3", 0)),
            v_transform=bool(args.get("v_transform", True)),
            euclid_sim=bool(args.get("euclid_sim", False)),
            elementwise_mul=bool(args.get("elementwise_mul", False)),
            recompute_so2=bool(args.get("recompute_so2", False)),
            ray_to_se3=bool(args.get("ray_to_se3", False)),
            zeroout_so3=bool(args.get("zeroout_so3", False)),
            id_so3=bool(args.get("id_so3", False)),
            use_bias=bool(args.get("use_bias", False)),
        )
        gta.validate()

    return AttnConfig(
        method=name,
        gta=gta,
        softmax=softmax,
        use_bias=bool(args.get("use_bias", False)),
        q_emb_dim=int(args.get("q_emb_dim", 0)),
        k_emb_dim=int(args.get("k_emb_dim", 0)),
        v_bias=bool(args.get("v_bias", False)),
        enable_scale=bool(args.get("enable_scale", False)),
        frustum_D=int(args.get("D", 0)),
        frustum_dmin=float(args.get("dmin", 0.1)),
        frustum_dmax=float(args.get("dmax", 10.0)),
        frustum_normalize=bool(args.get("normalize", False)),
        frustum_fourier=bool(args.get("fourier", False)),
        frustum_freqs=int(args.get("freqs", 15)),
        rpe=bool(args.get("rpe", False)),
        rpe_so2=int(args.get("so2", 0)),
    )


def _parse_encoder(kw: dict) -> EncoderConfig:
    emb = kw.get("emb", "ray")
    if emb is False:
        emb = None
    return EncoderConfig(
        dim=int(kw.get("dim", 768)),
        attdim=int(kw.get("attdim", 768)),
        num_conv_blocks=int(kw.get("num_conv_blocks", 3)),
        num_att_blocks=int(kw.get("num_att_blocks", 5)),
        pos_start_octave=int(kw.get("pos_start_octave", 0)),
        heads=int(kw.get("heads", 12)),
        dropout=float(kw.get("dropout") or 0.0),
        emb=emb,
        attn=_parse_attn(kw.get("attn_args", {})),
    )


def _parse_decoder(kw: dict) -> DecoderConfig:
    emb = kw.get("emb", "ray")
    if emb is False:
        emb = None
    return DecoderConfig(
        dim=int(kw.get("dim", 180)),
        num_att_blocks=int(kw.get("num_att_blocks", 2)),
        pos_start_octave=int(kw.get("pos_start_octave", 0)),
        z_dim=int(kw.get("z_dim", 768)),
        heads=int(kw.get("heads", 12)),
        rmlp_dim=int(kw.get("rmlp_dim", 1536)),
        act=kw.get("act", "lrelu"),
        dropout=float(kw.get("dropout") or 0.0),
        dim_head=kw.get("dim_head"),
        mlp_dim=kw.get("mlp_dim"),
        emb=emb,
        sigmoid=bool(kw.get("sigmoid", True)),
        return_last_attmap=bool(kw.get("return_last_attmap", False)),
        scale_h=float(kw.get("scale_h", 1.0)),
        scale_w=float(kw.get("scale_w", 1.0)),
        attn=_parse_attn(kw.get("attn_args", {})),
    )


def _parse_data(d: dict) -> DataConfig:
    kw = d.get("kwargs", {}) or {}
    name = d.get("dataset", "synthetic")
    h, w = (128, 128) if name == "msn" else (240, 320)
    return DataConfig(
        dataset=name,
        path=d.get("path") or "",
        num_points=int(d.get("num_points", 2048)),
        downsample=int(kw.get("downsample") or 0),
        downsample_input_coord=int(kw.get("downsample_input_coord") or 0),
        num_input_views=int(kw.get("num_input_views", 4)),
        num_target_views=int(kw.get("num_target_views", 1)),
        num_views=int(kw.get("num_views", 5 if name == "clevrtr" else 10)),
        overlap=bool(kw.get("overlap", False)),
        reconstruction=bool(kw.get("reconstruction", False)),
        camera_noise=float(kw.get("camera_noise") or 0.0),
        kubric_basis=bool(kw.get("kubric_basis", False)),
        image_coord=bool(kw.get("image_coord", False)),
        return_transform=bool(kw.get("return_transform", False)),
        canonical_view=bool(kw.get("canonical_view", True)),
        avoid_zerocamorg=bool(kw.get("avoid_zerocamorg", False)),
        height=int(kw.get("height", h)),
        width=int(kw.get("width", w)),
        shuffle=int(kw["shuffle"]) if kw.get("shuffle") else None,
        return_org_rays=bool(kw.get("return_org_rays", False)),
        return_org_images=bool(kw.get("return_org_images", False)),
        downsample_target=int(kw.get("downsample_target") or 0),
        load_depth=bool(kw.get("load_depth", False)),
    )


def _parse_training(t: dict) -> TrainConfig:
    grad_accum = int(t.get("grad_accum", 1))
    if grad_accum < 1:
        raise ValueError(f"training.grad_accum must be >= 1, got {grad_accum}")
    return TrainConfig(
        batch_size=int(t.get("batch_size", 32)),
        lr=float(t.get("lr", 1e-4)),
        lr_warmup=int(t.get("lr_warmup", 2500)),
        decay_it=int(t.get("decay_it", 4000000)),
        max_it=int(t.get("max_it", 1000000)),
        mixed_prec=bool(t.get("mixed_prec", False)),
        loss_scale=bool(t.get("loss_scale", False)),
        noadamW=bool(t.get("noadamW", False)),
        num_workers=int(t.get("num_workers", 1)),
        print_every=int(t.get("print_every", 100)),
        validate_every=int(t.get("validate_every", 10000)),
        visualize_every=int(t.get("visualize_every", 10000)),
        checkpoint_every=int(t.get("checkpoint_every", 1000)),
        backup_every=int(t.get("backup_every", 25000)),
        model_selection_metric=t.get("model_selection_metric", "psnr"),
        model_selection_mode=t.get("model_selection_mode", "maximize"),
        grad_accum=grad_accum,
    )


def config_from_dict(cfg: dict) -> Config:
    model = cfg.get("model", {})
    args = model.get("args", {})
    return Config(
        data=_parse_data(cfg.get("data", {})),
        model=ModelConfig(
            model_type=model.get("model_type", "tsrt"),
            encoder=_parse_encoder(args.get("encoder_kwargs", {})),
            decoder=_parse_decoder(args.get("decoder_kwargs", {})),
            ftl=bool(args.get("ftl", False)),
        ),
        training=_parse_training(cfg.get("training", {})),
        seed=int(cfg.get("seed", 0)),
    )


def load_config(path: str) -> Config:
    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    return config_from_dict(raw)
