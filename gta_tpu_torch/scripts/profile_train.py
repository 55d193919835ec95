"""Where the train step's time goes on the GPU: a torch.profiler window
over train_step of the GTA flagship and of the SRT baseline, summed by
kernel and by kind, with the device's busy and idle share of the window.

Usage (one CUDA card):
    python -m gta_tpu_torch.scripts.profile_train

Prints the card's name and power limit, then for train_step of each
configuration (batch 32, synthetic train scenes, dropout as configured),
over 3 steps after one warm-up step: the host wall time per step, the
device time summed over all kernels, the idle share (1 - device / wall),
device time by kind (this repo's attention forward and backward kernels,
GEMMs, convolutions, other), the top 15 kernels and every other kernel of
this repo. The models are randomly initialised from each config's seed;
times do not depend on the weights.
"""

from __future__ import annotations

import dataclasses
import subprocess

from gta_tpu_torch.scripts.profile_serving import BATCH, CONFIGS, attention_entry, profile


def main():
    import torch

    from gta_tpu_torch.config import load_config
    from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
    from gta_tpu_torch.train.trainer import Trainer

    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    for name, path in CONFIGS.items():
        cfg = load_config(path)
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="synthetic"))
        trainer = Trainer(cfg)
        train = SyntheticScenes(cfg.data, "train", seed=cfg.seed)
        batch = collate([train[i] for i in range(BATCH)]).to(trainer.device)
        profile(lambda: trainer.train_step(batch), f"{name} train_step_b{BATCH}", attention_entry(cfg))
        del trainer, batch


if __name__ == "__main__":
    main()
