"""SRT / TransformingSRT model wrappers (reference models_nvs.py).

The forward pass is a function of the SceneBatch: geometry contexts are
built by pure functions and threaded explicitly. TSRT flattens
[B, Nt, P] target queries into [B, Nt*P] (models_nvs.py:81-86).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from gta_tpu_torch.config import ModelConfig
from gta_tpu_torch.models.context import AttnContext, SceneBatch
from gta_tpu_torch.models.decoder import SRTDecoder, build_decoder_context
from gta_tpu_torch.models.encoder import SRTEncoder, build_encoder_context


class SRT(nn.Module):
    """Encoder-decoder novel-view-synthesis model."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = SRTEncoder(cfg.encoder)
        self.decoder = SRTDecoder(cfg.decoder)

    def encode(self, batch: SceneBatch) -> Tuple[torch.Tensor, AttnContext]:
        ctx = build_encoder_context(self.cfg.encoder, batch)
        return self.encoder(batch.input_images, ctx), ctx

    def decode(
        self, z: torch.Tensor, batch: SceneBatch, enc_ctx: Optional[AttnContext] = None
    ) -> Tuple[torch.Tensor, dict]:
        ctx = build_decoder_context(self.cfg.decoder, batch, enc_ctx)
        rays = batch.target_rays
        n_queries = rays.shape[1] * rays.shape[2] if rays.ndim == 4 else rays.shape[1]
        return self.decoder(z, n_queries, ctx)

    def forward(self, batch: SceneBatch) -> Tuple[torch.Tensor, dict]:
        z, enc_ctx = self.encode(batch)
        return self.decode(z, batch, enc_ctx)


class TransformingSRT(SRT):
    """`tsrt` model type. The FTL latent-transform baseline is not ported."""

    def __init__(self, cfg: ModelConfig):
        if cfg.ftl:
            raise NotImplementedError("FTL is not ported yet (ROADMAP queue 1, other attention methods)")
        super().__init__(cfg)


def build_model(cfg: ModelConfig) -> SRT:
    if cfg.model_type == "srt":
        return SRT(cfg)
    if cfg.model_type == "tsrt":
        return TransformingSRT(cfg)
    raise ValueError(f"unknown model_type {cfg.model_type}")
