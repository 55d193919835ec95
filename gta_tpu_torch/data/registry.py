"""Dataset registry (reference core.py:7-49 analogue; the JAX package's
gta_tpu/data/registry.py)."""

from __future__ import annotations

from gta_tpu_torch.config import DataConfig


def get_dataset(mode: str, cfg: DataConfig, full_scale: bool = False, max_len=None, seed: int = 0):
    if cfg.dataset == "synthetic":
        from gta_tpu_torch.data.synthetic import SyntheticScenes

        return SyntheticScenes(cfg, mode, full_scale=full_scale, seed=seed, max_len=max_len)
    if cfg.dataset == "clevrtr":
        from gta_tpu_torch.data.clevrtr import CLEVRTR

        return CLEVRTR(cfg, mode, full_scale=full_scale, max_len=max_len, seed=seed)
    if cfg.dataset == "msn":
        from gta_tpu_torch.data.msn import MultiShapeNet

        return MultiShapeNet(
            cfg, mode, full_scale=full_scale, max_len=max_len, seed=seed,
            shuffle=cfg.shuffle,
        )
    if cfg.dataset in ("re10k", "acid"):
        # identical on-disk format; 'acid' just points at an ACID dump
        from gta_tpu_torch.data.re10k import RealEstate10K

        return RealEstate10K(cfg, mode, full_scale=full_scale, max_len=max_len, seed=seed)
    raise ValueError(f"unknown dataset {cfg.dataset}")
