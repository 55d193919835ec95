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
from gta_tpu_torch.models.layers import set_compute_dtype


class SRT(nn.Module):
    """Encoder-decoder novel-view-synthesis model."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = SRTEncoder(cfg.encoder)
        self.decoder = SRTDecoder(cfg.decoder)

    def encode(self, batch: SceneBatch) -> Tuple[torch.Tensor, AttnContext]:
        ctx = build_encoder_context(self.cfg.encoder, batch)
        return self.encoder(batch.input_images, batch.input_camera_pos, batch.input_rays, ctx), ctx

    def decode(
        self, z: torch.Tensor, batch: SceneBatch, enc_ctx: Optional[AttnContext] = None
    ) -> Tuple[torch.Tensor, dict]:
        ctx = build_decoder_context(self.cfg.decoder, batch, enc_ctx)
        x, rays = batch.target_camera_pos, batch.target_rays
        if x.ndim == 4:  # [B, Nt, P, 3] -> [B, Nt*P, 3] (models_nvs.py:81-86)
            x = x.reshape(x.shape[0], -1, 3)
            rays = rays.reshape(rays.shape[0], -1, 3)
        return self.decoder(z, x, rays, ctx)

    def forward(self, batch: SceneBatch) -> Tuple[torch.Tensor, dict]:
        z, enc_ctx = self.encode(batch)
        return self.decode(z, batch, enc_ctx)


class TransformingSRT(SRT):
    """`tsrt` model type. The FTL latent-transform baseline is not ported."""

    def __init__(self, cfg: ModelConfig):
        if cfg.ftl:
            raise NotImplementedError("FTL is not ported yet (ROADMAP queue 1, other attention methods)")
        super().__init__(cfg)


def build_model(cfg: ModelConfig, dtype: torch.dtype = torch.float32) -> SRT:
    """The model of `cfg`, computing in `dtype` with fp32 parameters
    (gta_tpu/models/srt.py:108 `build_model(cfg, dtype)`; models/layers.py)."""
    if cfg.model_type == "srt":
        model = SRT(cfg)
    elif cfg.model_type == "tsrt":
        model = TransformingSRT(cfg)
    else:
        raise ValueError(f"unknown model_type {cfg.model_type}")
    return set_compute_dtype(model, dtype)
