"""Where the train step's time goes on the GPU: a torch.profiler window
over the flagship's train_step, summed by kernel and by kind, with the
device's busy and idle share of the window.

Usage (one CUDA card):
    python -m gta_tpu_torch.scripts.profile_train

Prints the card's name and power limit, then for train_step (the flagship
config, batch 32, synthetic train scenes, dropout as configured), over 3
steps after one warm-up step: the host wall time per step, the device time
summed over all kernels, the idle share (1 - device / wall), device time by
kind (the fused GTA forward and backward kernels, GEMMs, convolutions,
other) and the top 15 kernels. The model is randomly initialised from the
config's seed; times do not depend on the weights.
"""

from __future__ import annotations

import dataclasses
import subprocess

from gta_tpu_torch.scripts.profile_serving import profile

CONFIG = "runs/clevrtr/GTA/gta/config.yaml"
BATCH = 32  # the flagship config's batch size


def main():
    import torch

    from gta_tpu_torch.config import load_config
    from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
    from gta_tpu_torch.train.trainer import Trainer

    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    cfg = load_config(CONFIG)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="synthetic"))
    trainer = Trainer(cfg)
    train = SyntheticScenes(cfg.data, "train", seed=cfg.seed)
    batch = collate([train[i] for i in range(BATCH)]).to(trainer.device)
    profile(lambda: trainer.train_step(batch), f"train_step_b{BATCH}")


if __name__ == "__main__":
    main()
