"""What the tensor cores' TF32 path gives on the card: the throughput of
mma.sync, and how its fp32 accumulation drifts with the length of a chain
(csrc/tf32x3_probe.cu; the facts csrc/tf32x3.cuh is designed around).

Usage (one CUDA card):
    python -m gta_tpu_torch.scripts.probe_tf32x3

Prints the card's name and power limit, then
  * the TF32 rate (TFLOP/s) of mma.sync m16n8k8 with 8 and 16 warps per SM,
    each warp chaining 8 independent accumulators;
  * for sums of 24, 225 and 963 products (one tile of an attention core,
    P*V over 600 keys, the key pass over 2568 queries), the relative error
    of the tensor-core sum against the exact sum, as its mean (the bias)
    and standard deviation over 512 x 128 sums: in one chain, and in chains
    of 24 joined by fp32 round-to-nearest adds; beside them the same sums
    by PyTorch in fp32.
The operands are TF32-exact, uniform in [0.5, 1) (every product positive,
as P*V's weights are), so every product is exact and only the
accumulation errs.
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np

TILES = 512  # independent 16 x 8 sums per chain length
CHAINS = (24, 225, 963)


def _tf32(x: np.ndarray) -> np.ndarray:
    """x rounded to TF32 (10 mantissa bits), as csrc/tf32x3.cuh rounds."""
    u = x.astype(np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def main():
    import torch

    from gta_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        raise SystemExit("probe_tf32x3 needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _cuda.load("tf32x3_probe")
    lib.tf32x3_probe_rate.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.tf32x3_probe_chain.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    dev = torch.device("cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def check(err):
        if err != 0:
            raise RuntimeError(f"probe launch failed with cudaError {err}")

    iters = 4096
    for warps_per_sm in (8, 16):
        blocks, threads = 2 * sms, 16 * warps_per_sm
        out = torch.empty(blocks * threads, device=dev)
        check(lib.tf32x3_probe_rate(ctypes.c_void_p(out.data_ptr()), blocks, threads, 16, stream))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        check(lib.tf32x3_probe_rate(ctypes.c_void_p(out.data_ptr()), blocks, threads, iters, stream))
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        flops = blocks * threads / 32 * iters * 8 * 2 * 16 * 8 * 8
        print(f"mma.sync m16n8k8 tf32, {warps_per_sm} warps per SM: {flops / ms / 1e9:.1f} TFLOP/s ({ms:.4f} ms)")

    rng = np.random.RandomState(0)
    for steps in CHAINS:
        A = torch.from_numpy(_tf32(rng.uniform(0.5, 1.0, (TILES, steps, 16, 8)))).to(dev)
        B = torch.from_numpy(_tf32(rng.uniform(0.5, 1.0, (TILES, steps, 8, 8)))).to(dev)
        exact = torch.einsum("tsmk,tskn->tmn", A.double(), B.double())
        fp32 = torch.einsum("tsmk,tskn->tmn", A, B)
        cols = []
        for tile in (0, 24):
            D = torch.empty((TILES, 16, 8), device=dev)
            check(lib.tf32x3_probe_chain(ctypes.c_void_p(A.data_ptr()), ctypes.c_void_p(B.data_ptr()),
                                         ctypes.c_void_p(D.data_ptr()), TILES, steps, tile, stream))
            cols.append(D)
        torch.cuda.synchronize()

        def stats(x):
            r = (x.double() - exact) / exact
            return f"bias {r.mean().item():+.3e} sd {r.std().item():.3e}"

        print(f"sum of {steps} products: one tensor-core chain {stats(cols[0])}; chains of 24 + fp32 adds "
              f"{stats(cols[1])}; PyTorch fp32 {stats(fp32)}")


if __name__ == "__main__":
    main()
