"""Where the serving path's time goes on the GPU: a torch.profiler window
over eval_step and a full-frame render, summed by kernel and by kind, with
the device's busy and idle share of the window.

Usage (one CUDA card):
    python -m gta_tpu_torch.scripts.profile_serving

Prints the card's name and power limit, then for each configuration as
published (the GTA flagship and the CLEVR-TR SRT baseline at batch 32 and
fp32; msn_so3 and the MSN-Hard SRT baseline at batch 64 and bf16, their
`mixed_prec`) and each of eval_step (synthetic val
scenes) and one full-scale target view at chunk 16384
(render_image for the flagship, render_rays on the view's rays for the
non-transform SRT baseline), over 3 calls after one warm-up: the host wall
time per call, the device time summed over all kernels, the idle share
(1 - device / wall), device time by kind (this repo's attention kernels,
named by the entry the configuration launches, gta_fused or flash_core,
since both run the same attention core; GEMMs, convolutions, other), the
top 15 kernels and every other kernel of this repo. The models are
randomly initialised from each config's seed; times do not depend on the
weights.
"""

from __future__ import annotations

import dataclasses
import subprocess
import time
from collections import defaultdict

# name -> (config, batch size)
CONFIGS = {
    "gta": ("runs/clevrtr/GTA/gta/config.yaml", 32),
    "srt": ("runs/clevrtr/otherPEs/srt/config.yaml", 32),
    "msn_so3": ("runs/msn/GTA/gta_so3/config.yaml", 64),
    "msn_srt": ("runs/msn/otherPEs/srt/config.yaml", 64),
}
STEPS = 3  # profiled calls per phase
TOP = 15  # kernels listed per phase


def profiled_config(path: str):
    """The config at `path` on synthetic scenes, its compute dtype as
    published (`training.mixed_prec`)."""
    from gta_tpu_torch.config import load_config

    cfg = load_config(path)
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="synthetic"))


def attention_entry(cfg) -> str:
    """The kernels a configuration's attention layers launch: `gta_fused`
    (method 'gta') or `flash_core` (method '')."""
    return "gta_fused" if cfg.model.encoder.attn.is_gta else "flash_core"


def _kind(name: str, attention: str) -> str:
    """The kind of a kernel by its name. Each attention core (fp32
    csrc/attn_core.cuh, bf16 csrc/attn_sm90.cuh) is one set of kernels under
    both entries, so its forward and its two backward passes are counted
    under `attention`, the entry that the profiled configuration launches."""
    n = name.lower()
    if "attn_fwd" in n or "sm90_fwd" in n:
        return f"{attention}_fwd (this repo)"
    if "attn_bwd" in n or "sm90_bwd" in n or "gta_bwd" in n:  # the core's passes; GTA's dM reductions
        return f"{attention}_bwd (this repo)"
    if "gta_rows" in n and "centre" not in n:  # the C x C chains of both fused GTA kernels
        return "gta_fused row transforms (this repo)"
    if "mean_rows" in n or "centre" in n:
        return f"{attention} centres (this repo)"
    # cuDNN's fp32 conv algorithms: implicit GEMM ("fprop"), FFT, layout
    # transforms; checked before "gemm", which implicit-GEMM names contain
    conv_marks = ("conv", "fprop", "fft", "pointwise_mult_and_sum_complex", "nhwctonchw", "cudnn")
    if any(m in n for m in conv_marks):
        return "convolution (cuDNN)"
    if "gemm" in n or "nvjet" in n:  # cuBLAS's GEMMs (nvjet: its Hopper kernels in CUDA 12.8)
        return "gemm (cuBLAS)"
    if "memcpy" in n or "memset" in n:
        return "memcpy / memset"
    return "other (elementwise, norm, reduce)"


def profile(fn, label: str, attention: str):
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()  # warm-up outside the window
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] += ev.device_time_total
    device_us = sum(kernels.values())
    print(f"{label}: wall_ms_per_call={wall_us / STEPS / 1e3:.3f} "
          f"device_ms_per_call={device_us / STEPS / 1e3:.3f} idle_share={1 - device_us / wall_us:.4f}")
    by_kind = defaultdict(float)
    for name, us in kernels.items():
        by_kind[_kind(name, attention)] += us
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {label} kind {kind}: ms_per_call={us / STEPS / 1e3:.3f} share={us / device_us:.4f}")
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])
    for name, us in ranked[:TOP]:
        print(f"  {label} kernel {us / STEPS / 1e3:9.3f} ms  {name[:110]}")
    for name, us in ranked[TOP:]:  # this repo's kernels below the cut too
        if "this repo" in _kind(name, attention):
            print(f"  {label} kernel {us / STEPS / 1e3:9.3f} ms  {name[:110]}")


def main():
    import torch

    from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
    from gta_tpu_torch.train.trainer import Trainer

    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    for name, (path, batch_size) in CONFIGS.items():
        cfg = profiled_config(path)
        trainer = Trainer(cfg)
        val = SyntheticScenes(cfg.data, "val")
        batch = collate([val[i] for i in range(batch_size)])
        test = SyntheticScenes(cfg.data, "test", full_scale=True)
        item = collate([test[0]])
        h, w = test.target_h, test.target_w

        attention = attention_entry(cfg)
        print(f"{name}: compute dtype {str(trainer.dtype).replace('torch.', '')}", flush=True)
        profile(lambda: trainer.eval_step(batch), f"{name} eval_step_b{batch_size}", attention)
        if item.target_transforms is not None:
            profile(
                lambda: trainer.render_image(
                    item, h, w, target_transform=item.target_transforms[:, 0].numpy(), chunk=16384,
                    rays=item.target_rays[:, 0].numpy(), cam=item.target_camera_pos[:, 0].numpy(),
                ),
                f"{name} render_image_{h}x{w}", attention,
            )
        else:  # flat [1, Nt*h*w, 3] targets: the first view's rays
            profile(
                lambda: trainer.render_rays(
                    item, item.target_rays[:, : h * w].numpy(), item.target_camera_pos[:, : h * w].numpy(),
                    chunk=16384,
                ),
                f"{name} render_rays_{h}x{w}", attention,
            )
        del trainer, batch
        torch.cuda.empty_cache()

if __name__ == "__main__":
    main()
