"""Ray-conditioned cross-attention decoder (reference decoder.py).

RayPredictor: query embeddings (a learned constant, or each ray's
camera-position and direction encoding through the input MLP) cross-attend
into the scene latent through a depth-`num_att_blocks` transformer; a
4-hidden-layer render MLP maps the result to sigmoid RGB. Geometry context
comes from the pure function `build_decoder_context`, which reuses the
encoder's key tables.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from gta_tpu_torch.config import DecoderConfig
from gta_tpu_torch.geometry.coords import ray_posenc
from gta_tpu_torch.models.context import AttnContext, SceneBatch
from gta_tpu_torch.models.layers import Linear, Transformer, tagged, to_compute
from gta_tpu_torch.ops.reps import decoder_reps


def build_decoder_context(
    cfg: DecoderConfig, batch: SceneBatch, enc_ctx: Optional[AttnContext] = None
) -> AttnContext:
    """Precompute decoder-side geometry context; reuses encoder key tables."""
    if not cfg.attn.is_gta:
        return AttnContext()
    geom = decoder_reps(
        cfg.attn.gta,
        target_coord=batch.target_coord,
        target_transforms=batch.target_transforms,
        input_coord=batch.input_coord,
        input_transforms=batch.input_transforms,
        enc=enc_ctx.geom if enc_ctx is not None else None,
    )
    return AttnContext(geom=geom)


class RayPredictor(nn.Module):
    """Query embedding + cross-attention transformer (decoder.py:27-136).
    The queries enter the transformer in the compute dtype
    (gta_tpu/models/decoder.py:106, :124)."""

    compute_dtype = torch.float32

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        if cfg.emb not in ("const", "ray"):
            raise NotImplementedError(
                f"decoder emb {cfg.emb!r} is not ported yet (ROADMAP queue 1 item 7: planar, camera_planar)"
            )
        if cfg.return_last_attmap:
            raise NotImplementedError("return_last_attmap is not ported yet (ROADMAP queue 1)")
        self.cfg = cfg
        if cfg.emb == "const":
            self.initial_emb = nn.Parameter(torch.zeros(cfg.dim))
            tagged(self, "const_emb")
        else:
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

    def forward(self, z: torch.Tensor, x: torch.Tensor, rays: torch.Tensor, ctx: AttnContext) -> torch.Tensor:
        """z [B, K, z_dim], query camera positions x and ray directions rays
        [B, T, 3] -> [B, T, dim]."""
        if self.cfg.emb == "const":
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
        layers = []
        idim = cfg.dim
        for _ in range(4):
            layers += [tagged(Linear(idim, cfg.rmlp_dim), "srt"), _ACTS[cfg.act]()]
            idim = cfg.rmlp_dim
        layers.append(tagged(Linear(idim, 3), "srt"))
        self.render_mlp = nn.Sequential(*layers)

    def forward(
        self, z: torch.Tensor, x: torch.Tensor, rays: torch.Tensor, ctx: AttnContext
    ) -> Tuple[torch.Tensor, dict]:
        """z [B, K, z_dim], x and rays [B, T, 3] -> pixels [B, T, 3] (fp32
        whatever the compute dtype, gta_tpu/models/decoder.py:223)."""
        h = self.render_mlp(self.allocation_transformer(z, x, rays, ctx))
        pixels = torch.sigmoid(h) if self.cfg.sigmoid else h
        return pixels.float(), {}
