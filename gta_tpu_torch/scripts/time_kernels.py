"""Times of the four attention kernels at the decoder train shapes of the
configurations the port runs, in each dtype the kernels have an instance
for: a quick comparison of two builds of the kernels on one card.

Usage (one CUDA card), from the root of a checkout:
    python -m gta_tpu_torch.scripts.time_kernels [--label NAME] [--configs NAME ...]

Shapes (synthetic batches of each config's data, its train batch size):
the fused GTA forward (with its training residuals) and backward at
CLEVR-TR gta's decoder (B=32, 3x856 queries, 600 keys, C = 64) and msn_so3's
(B=64, 5x512 queries, 1280 keys, C = 96); flash_core forward and backward
at the SRT baselines' decoders (CLEVR-TR B=32 x 2560 x 600, MSN-Hard B=64 x
2560 x 1280, C = 64) and the MSN-Hard encoder's self-attention (B=64 x
1280 x 1280). CUDA events, median of 7 launches after 2 warm-up ones.
Prints the card's name and power limit, one line per time, and a JSON line
of them all, labelled with `--label`. With `--digest`, also one line per
kernel and shape with a SHA-256 digest of every output of one call (the
forward's output and residuals, the backward's gradients) on the same
seeded inputs: two builds whose digests agree computed the same bits.
`--configs` times only the named configs of CONFIGS (all by default). With
`--fp64`, also each fp32 flash_core output's relative L2 error against the
plain version in fp64 on the same inputs cut to B=2, beside the plain fp32
version's. Uses only the kernels' public wrappers, so it also times an
older checkout's kernels, run from its root, or with that root on
PYTHONPATH ahead of this script's checkout.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess

import numpy as np

CONFIGS = {  # name -> (config path, batch, also the encoder's self-attention)
    "clevr_gta": (("runs", "clevrtr", "GTA", "gta"), 32, False),
    "msn_so3": (("runs", "msn", "GTA", "gta_so3"), 64, False),
    "clevr_srt": (("runs", "clevrtr", "otherPEs", "srt"), 32, False),
    "msn_srt": (("runs", "msn", "otherPEs", "srt"), 64, True),
}


def pick_configs(names=None) -> dict:
    """The entries of CONFIGS named in `names`, in CONFIGS' order; all of
    them when `names` is empty or None. An unknown name raises."""
    unknown = sorted(set(names or ()) - set(CONFIGS))
    if unknown:
        raise SystemExit(f"unknown configs {unknown}; known: {list(CONFIGS)}")
    return {name: c for name, c in CONFIGS.items() if not names or name in names}


def time_ms(fn, runs=7, warmup=2):
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


def digest(outputs) -> str:
    """SHA-256 of the bytes of every tensor in `outputs` (nested tuples and
    the fields of residual objects), in order; None and non-tensors skipped."""
    import torch

    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, torch.Tensor):
            h.update(x.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif hasattr(x, "__dict__"):
            for y in vars(x).values():
                walk(y)

    walk(outputs)
    return h.hexdigest()[:16]


def flash_fp64_errors(fc, q, k, v, g, heads, scale) -> dict:
    """{output: (kernel, plain fp32)} relative L2 errors of flash_core's fp32
    forward and backward against its plain version in fp64."""
    import torch

    def rel(a, r):
        return ((a.double() - r).norm() / r.norm()).item()

    with torch.no_grad():
        out, lse = fc.flash_core_fwd(q, k, v, heads, scale, residuals=True)
        got = (out, *fc.flash_core_bwd(q, k, v, heads, scale, g, out, lse))
        plain = (fc.flash_core_fwd_plain(q, k, v, heads, scale), *fc.flash_core_bwd_plain(q, k, v, heads, scale, g))
        q, k, v, g = (x.double() for x in (q, k, v, g))
        ref = (fc.flash_core_fwd_plain(q, k, v, heads, scale), *fc.flash_core_bwd_plain(q, k, v, heads, scale, g))
    return {n: (rel(a, r), rel(p, r)) for n, a, p, r in zip(("out", "dq", "dk", "dv"), got, plain, ref)}


def main():
    import torch

    from gta_tpu_torch.config import load_config
    from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
    from gta_tpu_torch.ops import flash_core as fc
    from gta_tpu_torch.ops import gta_fused as tgf
    from gta_tpu_torch.ops.reps import decoder_reps, encoder_reps

    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--digest", action="store_true", help="print a digest of each kernel's outputs")
    ap.add_argument("--configs", nargs="*", help=f"time only these of {list(CONFIGS)}")
    ap.add_argument("--fp64", action="store_true", help="print fp32 flash_core's error against fp64")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    dtypes = [torch.float32] + ([torch.bfloat16] if hasattr(tgf.gta_fused_fwd, "launches_bf16") else [])
    results = {}
    for name, (parts, batch, encoder) in pick_configs(opts.configs).items():
        cfg = load_config(os.path.join(*parts, "config.yaml"))
        enc = cfg.model.encoder
        H, C = enc.heads, enc.attdim // enc.heads
        val = SyntheticScenes(cfg.data, "val")
        b = collate([val[i] for i in range(batch)]).to(dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        Tk = b.input_coord.shape[1] * b.input_coord.shape[2] if enc.attn.is_gta else None
        if enc.attn.is_gta:
            args = cfg.model.decoder.attn.gta
            reps = decoder_reps(args, target_coord=b.target_coord, target_transforms=b.target_transforms,
                                input_coord=b.input_coord, input_transforms=b.input_transforms,
                                enc=encoder_reps(enc.attn.gta, b.input_coord, b.input_transforms))
            Tq = b.target_coord[0].numel() // 2
            t = tgf.fused_tables(reps, args, torch.tensor([0.01], device=dev))
        else:
            d = cfg.data
            h, w = d.height // 2**d.downsample, d.width // 2**d.downsample
            Tk = d.num_input_views * (h >> enc.num_conv_blocks) * (w >> enc.num_conv_blocks)
            Tq = d.num_points
        for tq in (Tk, Tq) if encoder else (Tq,):
            q, k, v, g = (torch.randn((batch, T, H * C), generator=gen, device=dev) for T in (tq, Tk, Tk, tq))
            for dtype in dtypes:
                qq, kk, vv, gg = (x.to(dtype) for x in (q, k, v, g))
                tag = f"{name} B={batch} Tq={tq} Tk={Tk} C={C} {str(dtype).split('.')[-1]}"
                with torch.no_grad():
                    if enc.attn.is_gta:
                        first = tgf.gta_fused_fwd(qq, kk, vv, t, H, C**-0.5, residuals=True)
                        res = first[1]
                        fwd = time_ms(lambda: tgf.gta_fused_fwd(qq, kk, vv, t, H, C**-0.5, residuals=True))
                        bwd = time_ms(lambda: tgf.gta_fused_bwd(qq, kk, vv, t, H, C**-0.5, gg, res))
                        kernels = ("gta_fused_fwd", "gta_fused_bwd")
                        grads = tgf.gta_fused_bwd(qq, kk, vv, t, H, C**-0.5, gg, res) if opts.digest else None
                    else:
                        first = out, lse = fc.flash_core_fwd(qq, kk, vv, H, C**-0.5, residuals=True)
                        fwd = time_ms(lambda: fc.flash_core_fwd(qq, kk, vv, H, C**-0.5, residuals=True))
                        bwd = time_ms(lambda: fc.flash_core_bwd(qq, kk, vv, H, C**-0.5, gg, out, lse))
                        kernels = ("flash_core_fwd", "flash_core_bwd")
                        grads = fc.flash_core_bwd(qq, kk, vv, H, C**-0.5, gg, out, lse) if opts.digest else None
                if opts.fp64 and dtype == torch.float32 and not enc.attn.is_gta:
                    errors = flash_fp64_errors(fc, *(x[:2].contiguous() for x in (q, k, v, g)), H, C**-0.5)
                    print(f"fp64 {opts.label} flash_core {tag}[:2]: relative L2, kernel / plain fp32: "
                          + ", ".join(f"{n} {a:.3e} / {b:.3e}" for n, (a, b) in errors.items()), flush=True)
                    results[f"fp64 flash_core {tag}"] = errors
                if opts.digest:
                    for kernel, outputs in zip(kernels, (first, grads)):
                        print(f"digest {kernel} {tag}: {digest(outputs)}", flush=True)
                for kernel, ms in zip(kernels, (fwd, bwd)):
                    print(f"time {opts.label} {kernel} {tag}: {ms:.4f} ms", flush=True)
                    results[f"{kernel} {tag}"] = ms
                torch.cuda.empty_cache()
    print(json.dumps({"label": opts.label, "ms": results}), flush=True)


if __name__ == "__main__":
    main()
