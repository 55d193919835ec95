"""Dataset registry (reference core.py:7-49 analogue)."""

from __future__ import annotations

from gta_tpu_torch.config import DataConfig


def get_dataset(mode: str, cfg: DataConfig, full_scale: bool = False, max_len=None, seed: int = 0):
    if cfg.dataset == "synthetic":
        from gta_tpu_torch.data.synthetic import SyntheticScenes

        return SyntheticScenes(cfg, mode, full_scale=full_scale, seed=seed, max_len=max_len)
    raise NotImplementedError(
        f"dataset {cfg.dataset!r} is not ported yet (ROADMAP queue 1, other data families)"
    )
