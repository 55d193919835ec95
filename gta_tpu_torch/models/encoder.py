"""SRT-style multi-view patch encoder (reference encoder.py:36-345).

Images are NHWC at the API (the JAX package's layout); the conv stem runs
NCHW inside. With emb 'ray', each pixel's camera-position and ray-direction
encoding (180 channels) is concatenated to its RGB before the stem; with
'planar', the fixed 2D grid encoding of its pixel position (180 channels);
with 'camera_planar', the stem's output gains a linear map of the grid
encoding at its own resolution and one of each view's camera (the top
three rows of its input transform, 12 numbers). The
stem downsamples by 2**num_conv_blocks; patch tokens from all views are
concatenated and run through a depth-`num_att_blocks` self-attention
transformer. Geometry context comes from the pure function
`build_encoder_context`; the gbt and frustum_posemb baselines add their
embeddings to the patch tokens after the stem.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gta_tpu_torch.config import AttnConfig, EncoderConfig
from gta_tpu_torch.geometry.coords import posenc_2d_grid, ray_posenc
from gta_tpu_torch.geometry.frustum import frustum_pixel_points
from gta_tpu_torch.geometry.plucker import plucker_dist, plucker_params, plucker_posenc
from gta_tpu_torch.geometry.se3 import rigid_transform, se3_inverse
from gta_tpu_torch.models.context import AttnContext, SceneBatch
from gta_tpu_torch.models.layers import Conv2d, Linear, Transformer, tagged, to_compute
from gta_tpu_torch.ops.attention import at_least_fp32
from gta_tpu_torch.ops.reps import encoder_reps


def downsample_grid(x: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Strided center-sample downsample of [..., H, W, C] grids
    (reference common.py:105-110)."""
    if not num_steps or num_steps < 1:
        return x
    stride = 2**num_steps
    return x[..., stride // 2 :: stride, stride // 2 :: stride, :]


def _grid_emb(height: int, width: int, like: torch.Tensor) -> torch.Tensor:
    """posenc_2d_grid(180, height, width) channel-last [1, height, width,
    180], on `like`'s device in its dtype (the JAX package's
    `jnp.asarray(..., self.dtype)`)."""
    pe = np.ascontiguousarray(np.transpose(posenc_2d_grid(180, height, width), (1, 2, 0)))
    return torch.from_numpy(pe).to(device=like.device, dtype=like.dtype)[None]


def embed_camera_planar(x: torch.Tensor, planar: torch.Tensor, camera: torch.Tensor) -> torch.Tensor:
    """camera_planar's two adds after the stem, x + planar + camera
    (gta_tpu/models/encoder.py:177), as a TPU fuses the chain: computed in
    fp32 (at least) from the operands and rounded once to x's dtype."""
    return (at_least_fp32(x) + planar + camera).to(x.dtype)


class SRTConvBlock(nn.Module):
    """Conv3x3(s1)-ReLU-Conv3x3(s2)-ReLU, bias-free (encoder.py:16-33)."""

    def __init__(self, idim: int, hdim: int, odim: int):
        super().__init__()
        self.layers = nn.Sequential(
            tagged(Conv2d(idim, hdim, 3, padding=1, bias=False), "jax"),
            nn.ReLU(),
            tagged(Conv2d(hdim, odim, 3, stride=2, padding=1, bias=False), "jax"),
            nn.ReLU(),
        )

    def forward(self, x):
        return self.layers(x)


def _patch_rays(batch: SceneBatch) -> torch.Tensor:
    """The rays at the patch centres [B, N, T', 3] (the stem's 8x grid)."""
    rays = downsample_grid(batch.input_rays, 3)
    return rays.reshape(*rays.shape[:2], -1, 3)


def build_encoder_context(cfg: EncoderConfig, batch: SceneBatch, pose_octaves: int = 15,
                          ray_octaves: int = 15) -> AttnContext:
    """Precompute the encoder-side geometry context (pure function,
    gta_tpu/models/encoder.py:53-130)."""
    attn = cfg.attn
    ctx = AttnContext(
        input_transforms=batch.input_transforms, target_transforms=batch.target_transforms,
        input_coord=batch.input_coord, target_coord=batch.target_coord,
    )
    if attn.is_gta:
        ctx.geom = encoder_reps(
            attn.gta, input_coord=batch.input_coord, input_transforms=batch.input_transforms,
            input_rays=_patch_rays(batch) if attn.gta.ray_to_se3 else None,
        )
    elif attn.method in ("ape", "mln"):
        # the fixed-grid 2D PE over post-stem patches (encoder.py:309-313),
        # reshaped from [C, H, W] STRAIGHT to [-1, C] as the reference does:
        # a channel-major scramble the published models trained with
        H, W = batch.input_images.shape[2:4]
        s = 2**cfg.num_conv_blocks
        pe = torch.from_numpy(posenc_2d_grid(180, H // s, W // s).reshape(-1, 180)).to(batch.input_images.device)
        B, N = batch.input_images.shape[:2]
        ctx.input_coord_emb = pe[None, None].expand(B, N, *pe.shape)
    elif attn.method == "repast":
        # rays and positions of all patches in each key view's frame
        # (reference encoder.py:122-146)
        tfs = batch.input_transforms  # [B, N, 4, 4]
        rays = _patch_rays(batch)  # [B, N, L, 3]
        B, N = rays.shape[:2]
        pos = batch.input_camera_pos[:, :, None].expand(rays.shape)
        ctx.key_ray_emb = ray_posenc(rigid_transform(tfs, pos, 1.0), rigid_transform(tfs, rays, 0.0),
                                     pose_octaves, cfg.pos_start_octave, ray_octaves)
        T = N * rays.shape[2]
        pos_all = pos.reshape(B, 1, T, 3).expand(B, N, T, 3)
        rays_all = rays.reshape(B, 1, T, 3).expand(B, N, T, 3)
        query = ray_posenc(rigid_transform(tfs, pos_all, 1.0), rigid_transform(tfs, rays_all, 0.0),
                           pose_octaves, cfg.pos_start_octave, ray_octaves)
        ctx.query_ray_emb = query.transpose(1, 2)  # [B, T, Nk, 180]
    elif attn.method == "gbt":
        # Plücker pairwise distances and the late-fusion PE (encoder.py:148-163)
        rays = _patch_rays(batch)
        B = rays.shape[0]
        pos = batch.input_camera_pos[:, :, None].expand(rays.shape)
        pl = plucker_params(torch.cat([pos, rays], -1)).reshape(B, -1, 6)
        ctx.plucker_dist, ctx.gbt_ray_emb, ctx.gbt_ray_input = plucker_dist(pl, pl), plucker_posenc(pl), pl
    return ctx


def frustum_embedding(phi: nn.Module, attn: AttnConfig, coord: torch.Tensor, transforms: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """frustum_posemb's token embedding: the frustum points of `coord`
    [B, N, T, 2] in the frame of inv(`transforms`) (0.01-scaled with
    `normalize`, Fourier-encoded with `fourier`) through the MLP `phi`
    (encoder.py:170-190, decoder.py:229-245) -> [B, N, T, out]."""
    p3d = frustum_pixel_points(coord, se3_inverse(transforms), attn.frustum_D,
                               dmin=attn.frustum_dmin, dmax=attn.frustum_dmax)
    if attn.frustum_normalize:
        p3d = 0.01 * p3d
    if attn.frustum_fourier:
        p3d = plucker_posenc(p3d, attn.frustum_freqs)
    return phi(to_compute(p3d, dtype))


def frustum_phi(attn: AttnConfig, dim: int) -> nn.Sequential:
    """The frustum MLP: Linear(points, 2 dim) - ReLU - Linear(2 dim, dim)
    (flax frustum_phi0 / frustum_phi1)."""
    points = 4 * attn.frustum_D * (2 * attn.frustum_freqs if attn.frustum_fourier else 1)
    return nn.Sequential(tagged(Linear(points, 2 * dim), "jax"), nn.ReLU(), tagged(Linear(2 * dim, dim), "jax"))


class SRTEncoder(nn.Module):
    """Improved SRT encoder with pluggable attention method. The images and
    ray encodings enter the conv stem in the compute dtype
    (gta_tpu/models/encoder.py:149-155)."""

    compute_dtype = torch.float32

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        if cfg.emb not in (None, "ray", "planar", "camera_planar"):
            raise ValueError(f"unknown encoder emb {cfg.emb!r}")
        self.cfg = cfg
        self.ray_emb = cfg.emb == "ray" and cfg.attn.method != "repast"  # repast poses its keys itself
        # RGB (+ ray_posenc's 15/15 octaves, or the 180-channel grid encoding)
        idim = 3 + (180 if self.ray_emb or cfg.emb == "planar" else 0)
        blocks = [SRTConvBlock(idim, cfg.dim // 8, cfg.dim // 4)]
        cur = cfg.dim // 4
        for _ in range(1, cfg.num_conv_blocks):
            blocks.append(SRTConvBlock(cur, cur, 2 * cur))
            cur *= 2
        self.conv_blocks = nn.ModuleList(blocks)
        self.per_patch_linear = tagged(Conv2d(cur, cfg.attdim, 1), "jax")
        if cfg.emb == "camera_planar":  # before any method's embedding, as JAX's branches run
            self.lin_planar = tagged(Linear(180, cfg.attdim), "jax")
            self.lin_camera = tagged(Linear(12, cfg.attdim), "jax")
        elif cfg.attn.method == "gbt":
            self.lin_ray = tagged(Linear(180, cfg.attdim), "jax")  # over plucker_posenc's 6 x 15 x 2
        elif cfg.attn.method == "frustum_posemb":
            self.frustum_phi = frustum_phi(cfg.attn, cfg.attdim)
        self.transformer = Transformer(
            dim=cfg.attdim,
            depth=cfg.num_att_blocks,
            heads=cfg.heads,
            dim_head=cfg.attdim // cfg.heads,
            mlp_dim=cfg.attdim * 2,
            dropout=cfg.dropout,
            kv_dim=None,
            attn=cfg.attn,
        )

    def forward(
        self, images: torch.Tensor, camera_pos: torch.Tensor, rays: torch.Tensor, ctx: AttnContext
    ) -> torch.Tensor:
        """images, rays [B, N, H, W, 3], camera_pos [B, N, 3] -> scene latent
        [B, N*Ha*Wa, attdim]."""
        B, N, H, W, _ = images.shape
        x = to_compute(images.reshape(B * N, H, W, 3), self.compute_dtype)
        if self.ray_emb:
            pos = camera_pos.reshape(B * N, 1, 1, 3).expand(B * N, H, W, 3)
            emb = ray_posenc(pos, rays.reshape(B * N, H, W, 3), 15, self.cfg.pos_start_octave, 15)
            x = torch.cat([x, emb.to(x.dtype)], -1)
        elif self.cfg.emb == "planar":
            x = torch.cat([x, _grid_emb(H, W, x).expand(B * N, H, W, 180)], -1)
        x = x.permute(0, 3, 1, 2)
        for block in self.conv_blocks:
            x = block(x)
        x = self.per_patch_linear(x)  # [B*N, attdim, Ha, Wa]
        Ha, Wa = x.shape[2:]
        x = x.permute(0, 2, 3, 1).reshape(B, -1, self.cfg.attdim)  # tokens (view, row, column)
        method = self.cfg.attn.method
        if self.cfg.emb == "camera_planar":
            d = self.compute_dtype
            planar = self.lin_planar(to_compute(_grid_emb(Ha, Wa, x), d)).reshape(1, 1, Ha * Wa, -1)
            camera = self.lin_camera(to_compute(ctx.input_transforms[..., :3, :].reshape(B, N, 1, 12), d))
            x = embed_camera_planar(x.reshape(B, N, Ha * Wa, -1), planar, camera).reshape(B, -1, self.cfg.attdim)
        elif method == "gbt":
            x = x + self.lin_ray(to_compute(ctx.gbt_ray_emb, self.compute_dtype))
        elif method == "frustum_posemb":
            emb = frustum_embedding(self.frustum_phi, self.cfg.attn, ctx.input_coord, ctx.input_transforms,
                                    self.compute_dtype)
            x = x + emb.reshape(B, -1, self.cfg.attdim)
        return self.transformer(x, None, ctx)
