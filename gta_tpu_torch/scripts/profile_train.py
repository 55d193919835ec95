"""Where the train step's time goes on the GPU: a torch.profiler window
over train_step of the GTA flagship, the CLEVR-TR SRT baseline, msn_so3,
the MSN-Hard SRT baseline and the two DiT configs, summed by kernel and by
kind, with the device's busy and idle share of the window.

Usage (one CUDA card):
    python -m gta_tpu_torch.scripts.profile_train [--configs NAME ...]

Prints the card's name and power limit, then for train_step of each
configuration as published (the CLEVR-TR ones at batch 32 and fp32, the
msn ones at batch 64 and bf16, synthetic train scenes, dropout as
configured; dit_gta and dit_base at batch 256 and bf16 on procedural
images), over 3 steps after one warm-up step: the host wall time per step,
the device time summed over all kernels, the idle share (1 - device /
wall), device time by kind (this repo's attention forward and backward
kernels, GEMMs, convolutions, other), the top 15 kernels and every other
kernel of this repo. --configs picks some of them by name (gta, srt,
msn_so3, msn_srt, dit_gta, dit_base; default all). The models are randomly
initialised from each config's seed; times do not depend on the weights.
"""

from __future__ import annotations

import argparse
import subprocess

from gta_tpu_torch.scripts.profile_serving import CONFIGS, attention_entry, profile, profiled_config

# name -> (config, batch size)
DIT_CONFIGS = {
    "dit_gta": ("runs/imagenet/DiT/dit_gta/config.yaml", 256),
    "dit_base": ("runs/imagenet/DiT/dit_base/config.yaml", 256),
}


def main(argv=None):
    import torch

    from gta_tpu_torch.data.images import SyntheticImages, collate_images
    from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
    from gta_tpu_torch.train.dit_trainer import DiTTrainer, load_dit_config
    from gta_tpu_torch.train.trainer import Trainer

    parser = argparse.ArgumentParser()
    parser.add_argument("--configs", nargs="+", choices=[*CONFIGS, *DIT_CONFIGS], default=[*CONFIGS, *DIT_CONFIGS])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    for name in args.configs:
        if name in DIT_CONFIGS:
            path, batch_size = DIT_CONFIGS[name]
            cfg = load_dit_config(path)
            trainer = DiTTrainer(cfg)
            m = cfg.model
            train = SyntheticImages(m.input_size, m.num_classes, "train", batch_size, cfg.seed)
            batch = collate_images([train[i] for i in range(batch_size)])
            attention = "gta_fused" if m.attn.is_gta else "flash_core"
        else:
            path, batch_size = CONFIGS[name]
            cfg = profiled_config(path)
            trainer = Trainer(cfg)
            train = SyntheticScenes(cfg.data, "train", seed=cfg.seed)
            batch = collate([train[i] for i in range(batch_size)]).to(trainer.device)
            attention = attention_entry(cfg)
        torch.cuda.reset_peak_memory_stats()
        print(f"{name}: compute dtype {str(trainer.dtype).replace('torch.', '')}", flush=True)
        profile(lambda: trainer.train_step(batch), f"{name} train_step_b{batch_size}", attention)
        print(f"{name} train_step_b{batch_size}: peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
        del trainer, batch
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
