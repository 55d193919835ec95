"""Where the train step's time goes on the GPU: a torch.profiler window
over train_step of the GTA flagship, the CLEVR-TR SRT baseline, msn_so3
and the MSN-Hard SRT baseline, summed by kernel and by kind, with the
device's busy and idle share of the window.

Usage (one CUDA card):
    python -m gta_tpu_torch.scripts.profile_train

Prints the card's name and power limit, then for train_step of each
configuration as published (the CLEVR-TR ones at batch 32 and fp32, the
msn ones at batch 64 and bf16; synthetic train scenes, dropout as
configured),
over 3 steps after one warm-up step: the host wall time per step, the
device time summed over all kernels, the idle share (1 - device / wall),
device time by kind (this repo's attention forward and backward kernels,
GEMMs, convolutions, other), the top 15 kernels and every other kernel of
this repo. The models are randomly initialised from each config's seed;
times do not depend on the weights.
"""

from __future__ import annotations

import subprocess

from gta_tpu_torch.scripts.profile_serving import CONFIGS, attention_entry, profile, profiled_config


def main():
    import torch

    from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
    from gta_tpu_torch.train.trainer import Trainer

    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    for name, (path, batch_size) in CONFIGS.items():
        cfg = profiled_config(path)
        trainer = Trainer(cfg)
        train = SyntheticScenes(cfg.data, "train", seed=cfg.seed)
        batch = collate([train[i] for i in range(batch_size)]).to(trainer.device)
        torch.cuda.reset_peak_memory_stats()
        print(f"{name}: compute dtype {str(trainer.dtype).replace('torch.', '')}", flush=True)
        profile(lambda: trainer.train_step(batch), f"{name} train_step_b{batch_size}", attention_entry(cfg))
        print(f"{name} train_step_b{batch_size}: peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
        del trainer, batch
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
