#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gta_tpu_torch) on one NVIDIA GPU.

Usage, from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. The card's name and power limit; build every CUDA kernel of the port
     from gta_tpu_torch/csrc with nvcc (compiler resource report printed).
  2. Each kernel against its plain PyTorch version on the card, at the
     flagship CLEVR-TR GTA shapes (runs/clevrtr/GTA/gta): encoder
     self-attention B=32 x 600 tokens (2 views of 300), decoder eval
     B=32 x 3x856 queries, render chunk B=1 x 16384 queries, against 600
     keys, with rep tables from the port's encoder_reps/decoder_reps on a
     synthetic batch and trans_coeff 0.01; plus every flag branch of the
     kernel at B=2. Pass: max|kernel - plain| <= 1e-4 in fp32 (the order of
     summation over 600 keys differs). Times: CUDA events, median of 7
     after 2 warm-up runs. The yardstick F.scaled_dot_product_attention on
     pre-transformed q/k/v is timed here only; the port never calls it.
  3. The main path at full width: Trainer(cfg) on cuda, eval_step on a
     batch-32 synthetic val batch, render_image of one full-scale 240x320
     target view at chunk 16384 (one warm-up, then the median of 3), with the
     kernel's launch count asserted (5 per encode, 2 per decode chunk); then a B=2 forward on the card
     against the same weights on the CPU (plain version), atol 1e-4.
  4. One JSON line of kernel numbers, then the device JSON as the last line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "runs", "clevrtr", "GTA", "gta", "config.yaml")
TOL = 1e-4
# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TIMED_RUNS, WARMUP = 7, 2
EVAL_BATCH = 32  # the flagship config's batch size
RENDER_CHUNK = 16384  # the evaluation protocol's chunk
RENDER_RUNS = 3  # timed full-frame renders, after one warm-up


def time_ms(fn, runs=TIMED_RUNS, warmup=WARMUP) -> float:
    """Median CUDA-event time of `fn` in ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def fused_cost(t, B, H, Tq, Tk, C):
    """(flops, bytes) the fused forward must do and move: matmul flops of
    the core and the per-view transforms; each input read once, the output
    written once."""
    flops = 4.0 * Tq * Tk * C
    flops += 2.0 * Tq * C * C * ((t.mq is not None) + (t.mo is not None and t.v_transform))
    flops += 2.0 * Tk * C * C * (t.mk is not None) * (1 + t.v_transform)
    flops *= B * H
    tables = [t.mq, t.mk, t.mo, t.cq, t.sq, t.ck, t.sk]
    n_bytes = 4.0 * (2 * B * Tq * H * C + 2 * B * Tk * H * C + sum(x.numel() for x in tables if x is not None))
    return flops, n_bytes


def kernel_phase(cfg, device):
    """Kernel vs plain at the flagship shapes; returns per-shape numbers."""
    import torch
    import torch.nn.functional as F

    from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
    from gta_tpu_torch.geometry.coords import make_2dcoord
    from gta_tpu_torch.ops import gta_fused as tgf
    from gta_tpu_torch.ops.gta import gta_transform_qkv
    from gta_tpu_torch.ops.reps import decoder_reps, encoder_reps

    enc_cfg, dec_cfg = cfg.model.encoder, cfg.model.decoder
    H, C = enc_cfg.heads, enc_cfg.attdim // enc_cfg.heads
    scale = C**-0.5
    tc = torch.tensor([0.01], device=device)
    val = SyntheticScenes(cfg.data, "val")
    b32 = collate([val[i] for i in range(EVAL_BATCH)]).to(device)
    enc32 = encoder_reps(enc_cfg.attn.gta, b32.input_coord, b32.input_transforms)
    dec32 = decoder_reps(
        dec_cfg.attn.gta, target_coord=b32.target_coord, target_transforms=b32.target_transforms,
        input_coord=b32.input_coord, input_transforms=b32.input_transforms, enc=enc32,
    )
    full = collate([SyntheticScenes(cfg.data, "test", full_scale=True)[0]]).to(device)
    enc1 = encoder_reps(enc_cfg.attn.gta, full.input_coord, full.input_transforms)
    coord = make_2dcoord(cfg.data.height, cfg.data.width).reshape(1, 1, -1, 2)[:, :, :RENDER_CHUNK]
    coord = torch.from_numpy(coord).to(device)
    dec1 = decoder_reps(
        dec_cfg.attn.gta, target_coord=coord, target_transforms=full.target_transforms[:, :1],
        input_coord=full.input_coord, input_transforms=full.input_transforms, enc=enc1,
    )
    Tk = b32.input_coord.shape[1] * b32.input_coord.shape[2]
    shapes = {
        "encoder_self_b32": (enc_cfg.attn.gta, enc32, EVAL_BATCH, Tk),
        "decoder_eval_b32": (dec_cfg.attn.gta, dec32, EVAL_BATCH, b32.target_coord[0].numel() // 2),
        "render_chunk_b1": (dec_cfg.attn.gta, dec1, 1, coord.shape[2]),
    }
    gen = torch.Generator(device=device).manual_seed(0)
    results = {}
    for name, (args, reps, B, Tq) in shapes.items():
        qB = torch.randn((B, Tq, H * C), generator=gen, device=device)
        kB = torch.randn((B, Tk, H * C), generator=gen, device=device)
        vB = torch.randn((B, Tk, H * C), generator=gen, device=device)
        with torch.no_grad():
            tgf.check_supported(reps, args, Tq, Tk)
            t = tgf.fused_tables(reps, args, tc)
            got = tgf.gta_fused_fwd(qB, kB, vB, t, H, scale)
            torch.cuda.synchronize()
            want = tgf.gta_fused_fwd_plain(qB, kB, vB, t, H, scale)
            err = (got - want).abs().max().item()
            ms = time_ms(lambda: tgf.gta_fused_fwd(qB, kB, vB, t, H, scale))
            plain_ms = time_ms(lambda: tgf.gta_fused_fwd_plain(qB, kB, vB, t, H, scale), runs=5)

            def heads(x):
                return x.reshape(B, x.shape[1], H, C).transpose(1, 2)

            qt, kt, vt = (x.contiguous() for x in gta_transform_qkv(heads(qB), heads(kB), heads(vB), reps, args, tc))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale))
        flops, n_bytes = fused_cost(t, B, H, Tq, Tk, C)
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
        results[name] = {
            "B": B, "Tq": Tq, "Tk": Tk, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "mbytes": n_bytes / 1e6,
        }
        print(f"kernel gta_fused_fwd {name}: B={B} Tq={Tq} Tk={Tk} max|d|={err:.3e} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={library_ms:.4f} "
              f"bound_ms={max(t_ops, t_bytes):.4f} ({results[name]['bound_by']})", flush=True)
        if not err <= TOL:
            raise AssertionError(f"gta_fused_fwd {name}: max|kernel - plain| = {err} > {TOL}")
        del qB, kB, vB, got, want, qt, kt, vt
        torch.cuda.empty_cache()
    return results


def branch_phase(device):
    """Every flag branch of the kernel (C = 64) against the plain version."""
    import torch

    from gta_tpu_torch.config import FDims, GTAArgs
    from gta_tpu_torch.ops import gta_fused as tgf
    from gta_tpu_torch.ops.reps import encoder_reps

    rng = np.random.RandomState(0)
    coord = torch.from_numpy(rng.rand(2, 2, 300, 2).astype(np.float32)).to(device)
    ang = rng.rand(2, 2) * 6.28
    tf = np.tile(np.eye(4, dtype=np.float32), (2, 2, 1, 1))
    tf[..., 0, 0], tf[..., 0, 1], tf[..., 1, 0], tf[..., 1, 1] = np.cos(ang), -np.sin(ang), np.sin(ang), np.cos(ang)
    tf[..., :3, 3] = rng.randn(2, 2, 3)
    tf = torch.from_numpy(tf).to(device)
    worst = 0.0
    for fd, so2, vt in [
        (dict(se3=64), 0, True),
        (dict(so2=64), 16, True),
        (dict(triv=16, se3=16, so2=32), 8, False),
        (dict(triv=16, se3=16, so2=32), 8, True),
    ]:
        args = GTAArgs(f_dims=FDims(**fd), so2=so2, v_transform=vt)
        reps = encoder_reps(args, coord, tf)
        q, k, v = (torch.from_numpy(rng.randn(2, 600, 384).astype(np.float32)).to(device) for _ in range(3))
        with torch.no_grad():
            t = tgf.fused_tables(reps, args, torch.tensor([0.3], device=device))
            got = tgf.gta_fused_fwd(q, k, v, t, 6, 0.125)
            torch.cuda.synchronize()
            err = (got - tgf.gta_fused_fwd_plain(q, k, v, t, 6, 0.125)).abs().max().item()
        print(f"kernel gta_fused_fwd branch {fd} so2={so2} v_transform={vt}: max|d|={err:.3e}", flush=True)
        if not err <= TOL:
            raise AssertionError(f"gta_fused_fwd branch {fd}: max|kernel - plain| = {err} > {TOL}")
        worst = max(worst, err)
    return worst


def main_path_phase(cfg):
    """Full-width serving path through the kernels; returns launch count."""
    import torch

    from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
    from gta_tpu_torch.ops import gta_fused as tgf
    from gta_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg)  # default device: cuda
    enc_layers, dec_layers = cfg.model.encoder.num_att_blocks, cfg.model.decoder.num_att_blocks
    val = SyntheticScenes(cfg.data, "val")
    batch = collate([val[i] for i in range(EVAL_BATCH)])
    test = SyntheticScenes(cfg.data, "test", full_scale=True)
    item = collate([test[0]])
    Hf, Wf, chunk = test.target_h, test.target_w, RENDER_CHUNK
    n_chunks = -(-Hf * Wf // chunk)

    tgf.gta_fused_fwd.launches = 0
    step_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        m = trainer.eval_step(batch)
        psnr = m["psnr"].mean().item()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    rays = batch.target_pixels.shape[0] * batch.target_pixels.shape[1] * batch.target_pixels.shape[2]

    def render():
        return trainer.render_image(
            item, Hf, Wf, target_transform=item.target_transforms[:, 0].numpy(), chunk=chunk,
            rays=item.target_rays[:, 0].numpy(), cam=item.target_camera_pos[:, 0].numpy(),
        )

    img = render()  # warm-up for the render shapes
    render_ms = []
    for _ in range(RENDER_RUNS):
        t0 = time.perf_counter()
        img = render()
        torch.cuda.synchronize()
        render_ms.append((time.perf_counter() - t0) * 1e3)
    launches = tgf.gta_fused_fwd.launches

    want = 3 * (enc_layers + dec_layers) + (1 + RENDER_RUNS) * (enc_layers + dec_layers * n_chunks)
    print(f"main path: eval_step B={EVAL_BATCH} psnr={psnr:.4f} ms(cold,warm,warm)="
          f"{', '.join(f'{x:.2f}' for x in step_ms)} rays/s={rays / (min(step_ms[1:]) / 1e3):.0f}", flush=True)
    gt = item.target_pixels[:, 0].numpy().reshape(1, Hf, Wf, 3)
    render_psnr = float(-10.0 * np.log10(np.mean((img - gt) ** 2)))
    median_ms = float(np.median(render_ms))
    print(f"main path: render_image {Hf}x{Wf} chunk={chunk} psnr={render_psnr:.4f} "
          f"ms(median of {RENDER_RUNS} after 1 warm-up)={median_ms:.2f} "
          f"[{', '.join(f'{x:.2f}' for x in render_ms)}] rays/s={Hf * Wf / (median_ms / 1e3):.0f}", flush=True)
    print(f"main path: gta_fused_fwd launches={launches} expected={want} "
          "(each launch of the C entry point runs the K/V prologue kernel, then the main kernel)", flush=True)
    if launches != want:
        raise AssertionError(f"gta_fused_fwd launched {launches} times on the main path, expected {want}")
    if img.shape != (1, Hf, Wf, 3) or not np.isfinite(img).all() or not np.isfinite(psnr):
        raise AssertionError("main path output is not finite / of the expected shape")

    # the same weights on the CPU through the plain version
    cpu = Trainer(cfg, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in trainer.model.state_dict().items()})
    small = collate([val[i] for i in range(2)])
    with torch.no_grad():
        got, _ = trainer.model(small.to(trainer.device))
        want_px, _ = cpu.model(small)
    err = (got.cpu() - want_px).abs().max().item()
    print(f"main path: B=2 forward cuda vs cpu max|d pixels|={err:.3e}", flush=True)
    if not err <= TOL:
        raise AssertionError(f"card vs CPU pixels differ by {err} > {TOL}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from gta_tpu_torch.config import load_config
    from gta_tpu_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    _cuda.build()
    print(f"built kernels {list(_cuda.KERNELS)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in _cuda.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"nvcc {name}: {line.strip()}", flush=True)

    cfg = load_config(CONFIG)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="synthetic"))
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    shapes = kernel_phase(cfg, device)
    branch_err = branch_phase(device)
    launches = main_path_phase(cfg)

    main_shape = shapes["decoder_eval_b32"]
    kernel = {
        "name": "gta_fused_fwd",
        "route": "cuda",
        "source": "gta_tpu_torch/csrc/gta_fused_fwd.cu",
        "replaces": "gta_tpu/ops/gta_fused.py:209",
        "launches": launches,
        "max_abs_err": max([branch_err] + [s["max_abs_err"] for s in shapes.values()]),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "shape": "decoder_eval_b32",
        "shapes": shapes,
    }
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
