"""Ray-conditioned cross-attention decoder (reference decoder.py).

RayPredictor: query embeddings (a learned constant, or through the input
MLP each ray's camera-position and direction encoding ('ray'), its target
pixel's 2D coordinate encoding ('planar', 180 channels) or that and the
target view's camera, the top three rows of its transform ('camera_planar',
180 + 12), or frustum_posemb's frustum-point MLP) cross-attend into the scene latent
through a depth-`num_att_blocks` transformer; a 4-hidden-layer render MLP
maps the result to sigmoid RGB. Geometry context comes from the pure
function `build_decoder_context`, which reuses the encoder's key tables.
repast takes each query ray in every key view's frame and averages the
per-view results; gbt's queries are the rays' Plücker coordinates. With
return_last_attmap (heads = 1), the decoder also returns the last block's
attention map over the scene latent as `masks` [B, Tq, Tk] (a soft
segmentation, gta_tpu/models/decoder.py:209-211).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from gta_tpu_torch.config import DecoderConfig
from gta_tpu_torch.geometry.coords import posenc_2d_coord, ray_posenc
from gta_tpu_torch.geometry.plucker import plucker_dist, plucker_params
from gta_tpu_torch.geometry.se3 import rigid_transform
from gta_tpu_torch.models.context import AttnContext, SceneBatch
from gta_tpu_torch.models.encoder import downsample_grid, frustum_embedding, frustum_phi
from gta_tpu_torch.models.layers import Linear, Transformer, tagged, to_compute
from gta_tpu_torch.ops.attention import at_least_fp32
from gta_tpu_torch.ops.reps import decoder_reps


def build_decoder_context(
    cfg: DecoderConfig, batch: SceneBatch, enc_ctx: Optional[AttnContext] = None
) -> AttnContext:
    """Precompute decoder-side geometry context; reuses encoder key tables
    (gta_tpu/models/decoder.py:28-80)."""
    attn = cfg.attn
    ctx = AttnContext(
        input_transforms=batch.input_transforms, target_transforms=batch.target_transforms,
        input_coord=batch.input_coord, target_coord=batch.target_coord,
    )
    if attn.is_gta:
        ray_to_se3 = attn.gta.ray_to_se3
        ctx.geom = decoder_reps(
            attn.gta,
            target_coord=batch.target_coord,
            target_transforms=batch.target_transforms,
            target_rays=(batch.target_rays.reshape(*batch.target_transforms.shape[:2], -1, 3)
                         if ray_to_se3 else None),
            input_coord=batch.input_coord,
            input_transforms=batch.input_transforms,
            input_rays=(downsample_grid(batch.input_rays, 3).reshape(*batch.input_rays.shape[:2], -1, 3)
                        if ray_to_se3 else None),
            enc=enc_ctx.geom if enc_ctx is not None else None,
        )
    elif attn.method in ("ape", "mln"):
        ctx.target_coord_emb = posenc_2d_coord(180, batch.target_coord, (cfg.scale_h, cfg.scale_w))
        ctx.input_coord_emb = enc_ctx.input_coord_emb if enc_ctx is not None else None
    elif attn.method == "repast":
        ctx.key_ray_emb = enc_ctx.key_ray_emb if enc_ctx is not None else None
    elif attn.method == "gbt":
        # query rays against the input patch rays (decoder.py:222-227)
        B = batch.target_camera_pos.shape[0]
        pos, rays = batch.target_camera_pos.reshape(B, -1, 3), batch.target_rays.reshape(B, -1, 3)
        ctx.plucker_dist = plucker_dist(plucker_params(torch.cat([pos, rays], -1)), enc_ctx.gbt_ray_input)
    return ctx


class RayPredictor(nn.Module):
    """Query embedding + cross-attention transformer (decoder.py:27-136).
    The queries enter the transformer in the compute dtype
    (gta_tpu/models/decoder.py:106, :124)."""

    compute_dtype = torch.float32

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.frustum = cfg.attn.method == "frustum_posemb"  # queries come from SRTDecoder
        if cfg.emb not in ("const", "ray", "planar", "camera_planar") and not self.frustum:
            raise ValueError(f"unknown decoder emb {cfg.emb!r}")
        self.cfg = cfg
        if cfg.emb == "const" and not self.frustum:
            self.initial_emb = nn.Parameter(torch.zeros(cfg.dim))
            tagged(self, "const_emb")
        elif not self.frustum:
            # OSRT input MLP (decoder.py:70-77) over the query embedding:
            # ray_posenc's or the 2D coordinates' 180 channels, + 12 camera
            # entries for camera_planar
            width = 192 if cfg.emb == "camera_planar" else 180
            self.input_mlp = nn.Sequential(
                tagged(Linear(width, 360), "srt"), nn.ReLU(), tagged(Linear(360, cfg.dim), "srt")
            )
        self.transformer = Transformer(
            dim=cfg.dim,
            depth=cfg.num_att_blocks,
            heads=cfg.heads,
            dim_head=cfg.head_dim,
            mlp_dim=cfg.ff_dim,
            dropout=cfg.dropout,
            kv_dim=cfg.z_dim,
            attn=cfg.attn,
            return_last_attmap=cfg.return_last_attmap,
        )

    def forward(self, z: torch.Tensor, x: torch.Tensor, rays: torch.Tensor, ctx: AttnContext,
                queries: Optional[torch.Tensor] = None) -> torch.Tensor:
        """z [B, K, z_dim], query camera positions x and ray directions rays
        [B, T, 3] (repast: [B, T, Nk, 3]) -> [B, T, dim] ([B, T, Nk, dim]),
        with return_last_attmap (out, the last block's attention map);
        `queries` given (frustum_posemb) skip the embedding."""
        cfg = self.cfg
        B, T = rays.shape[:2]
        if queries is not None:
            pass
        elif cfg.emb == "const":
            emb = to_compute(self.initial_emb, self.compute_dtype)
            queries = emb.expand(z.shape[0], rays.shape[1], cfg.dim)
        else:
            if cfg.emb == "ray":
                emb = ray_posenc(x, rays, 15, cfg.pos_start_octave, 15)
            else:  # the target pixels' coordinates (+ their view's camera)
                coord = ctx.target_coord  # [B, Nt, P, 2]
                emb = posenc_2d_coord(180, coord, (cfg.scale_h, cfg.scale_w))
                if cfg.emb == "camera_planar":
                    cam = ctx.target_transforms[:, :, :3].reshape(B, -1, 1, 12)
                    emb = torch.cat([emb, cam.expand(*coord.shape[:3], 12)], -1)
                emb = emb.reshape(B, T, -1)
            queries = self.input_mlp(to_compute(emb, self.compute_dtype))
        return self.transformer(queries, z, ctx)


_ACTS = {"relu": nn.ReLU, "lrelu": nn.LeakyReLU, "gelu": nn.GELU}


def render_pixels(h: torch.Tensor, sigmoid: bool = True) -> torch.Tensor:
    """The render MLP's output [..., 3] (the compute dtype) -> fp32 pixels:
    the sigmoid computed in fp32 from h, unrounded. The chain
    `nn.sigmoid(h).astype(float32)` (gta_tpu/models/decoder.py:222-223)
    ends in fp32, so a TPU rounds it to nothing coarser."""
    h = at_least_fp32(h)
    return (torch.sigmoid(h) if sigmoid else h).float()


class SRTDecoder(nn.Module):
    """RayPredictor + render MLP (decoder.py:139-384)."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.allocation_transformer = RayPredictor(cfg)
        if cfg.attn.method == "frustum_posemb":
            self.frustum_phi = frustum_phi(cfg.attn, cfg.dim)
        layers = []
        idim = cfg.dim
        for _ in range(4):
            layers += [tagged(Linear(idim, cfg.rmlp_dim), "srt"), _ACTS[cfg.act]()]
            idim = cfg.rmlp_dim
        layers.append(tagged(Linear(idim, 3), "srt"))
        self.render_mlp = nn.Sequential(*layers)

    compute_dtype = torch.float32

    def forward(
        self, z: torch.Tensor, x: torch.Tensor, rays: torch.Tensor, ctx: AttnContext
    ) -> Tuple[torch.Tensor, dict]:
        """z [B, K, z_dim], x and rays [B, T, 3] -> (pixels [B, T, 3] (fp32
        whatever the compute dtype, gta_tpu/models/decoder.py:223), aux: with
        return_last_attmap, `masks` [B, T, K])."""
        method = self.cfg.attn.method
        queries = None
        if method == "repast":
            # each query ray in every key view's frame (decoder.py:206-220):
            # [B, T, Nk, 3], per view through attention
            tfs = ctx.input_transforms  # [B, Nk, 4, 4]
            B, T, Nk = x.shape[0], x.shape[1], tfs.shape[1]
            x = rigid_transform(tfs, x[:, None].expand(B, Nk, T, 3), 1.0).transpose(1, 2)
            rays = rigid_transform(tfs, rays[:, None].expand(B, Nk, T, 3), 0.0).transpose(1, 2)
        elif method == "gbt":
            # the queries are the rays' Plücker coordinates (decoder.py:222-227)
            x, rays = plucker_params(torch.cat([x, rays], -1)).chunk(2, -1)
        elif method == "frustum_posemb":
            emb = frustum_embedding(self.frustum_phi, self.cfg.attn, ctx.target_coord, ctx.target_transforms,
                                    self.compute_dtype)
            queries = emb.reshape(emb.shape[0], -1, self.cfg.dim)
        out = self.allocation_transformer(z, x, rays, ctx, queries)
        aux = {}
        if self.cfg.return_last_attmap:
            out, attmap = out
            aux["masks"] = attmap[:, 0]  # heads = 1 (the reference asserts it)
        if method == "repast":
            out = out.mean(2)  # over the key views
        h = self.render_mlp(out)
        return render_pixels(h, self.cfg.sigmoid), aux
