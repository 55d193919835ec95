"""Ray-conditioned cross-attention decoder (reference decoder.py).

RayPredictor: query embeddings (a learned constant, or each ray's
camera-position and direction encoding through the input MLP, or
frustum_posemb's frustum-point MLP) cross-attend into the scene latent
through a depth-`num_att_blocks` transformer; a 4-hidden-layer render MLP
maps the result to sigmoid RGB. Geometry context comes from the pure
function `build_decoder_context`, which reuses the encoder's key tables.
repast takes each query ray in every key view's frame and averages the
per-view results; gbt's queries are the rays' Plücker coordinates.
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
        if cfg.emb not in ("const", "ray") and not self.frustum:
            raise NotImplementedError(
                f"decoder emb {cfg.emb!r} is not ported yet (ROADMAP queue 1 item 7: planar, camera_planar)"
            )
        if cfg.return_last_attmap:
            raise NotImplementedError("return_last_attmap is not ported yet (ROADMAP queue 1 item 7)")
        self.cfg = cfg
        if cfg.emb == "const" and not self.frustum:
            self.initial_emb = nn.Parameter(torch.zeros(cfg.dim))
            tagged(self, "const_emb")
        elif not self.frustum:
            # OSRT input MLP (decoder.py:70-77) over ray_posenc's 180 channels
            self.input_mlp = nn.Sequential(
                tagged(Linear(180, 360), "srt"), nn.ReLU(), tagged(Linear(360, cfg.dim), "srt")
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
        )

    def forward(self, z: torch.Tensor, x: torch.Tensor, rays: torch.Tensor, ctx: AttnContext,
                queries: Optional[torch.Tensor] = None) -> torch.Tensor:
        """z [B, K, z_dim], query camera positions x and ray directions rays
        [B, T, 3] (repast: [B, T, Nk, 3]) -> [B, T, dim] ([B, T, Nk, dim]);
        `queries` given (frustum_posemb) skip the embedding."""
        if queries is not None:
            pass
        elif self.cfg.emb == "const":
            emb = to_compute(self.initial_emb, self.compute_dtype)
            queries = emb.expand(z.shape[0], rays.shape[1], self.cfg.dim)
        else:
            emb = ray_posenc(x, rays, 15, self.cfg.pos_start_octave, 15)
            queries = self.input_mlp(to_compute(emb, self.compute_dtype))
        return self.transformer(queries, z, ctx)


_ACTS = {"relu": nn.ReLU, "lrelu": nn.LeakyReLU, "gelu": nn.GELU}


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
        """z [B, K, z_dim], x and rays [B, T, 3] -> pixels [B, T, 3] (fp32
        whatever the compute dtype, gta_tpu/models/decoder.py:223)."""
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
        if method == "repast":
            out = out.mean(2)  # over the key views
        h = self.render_mlp(out)
        pixels = torch.sigmoid(h) if self.cfg.sigmoid else h
        return pixels.float(), {}
