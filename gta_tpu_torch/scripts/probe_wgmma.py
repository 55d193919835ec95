"""What the wgmma and TMA path of csrc/attn_sm90.cuh gives on the card: its
two product forms against PyTorch, how wgmma's fp32 accumulation drifts
with the length of a chain, and its throughput (csrc/wgmma_probe.cu; the
facts the bf16 attention core is designed around).

Usage (one CUDA card):
    python -m gta_tpu_torch.scripts.probe_wgmma

Prints the card's name and power limit, then
  * for head widths 64 and 96, the largest difference of S = a b^T (both
    operands K-major in shared memory) and O = bf16(S) v (S in registers,
    v MN-major) from the same products in fp64 on the same bf16 operands
    (O's: the kernel's S rounded to bf16),
    with the descriptors as the kernels build them and with the MN-major
    descriptor's two byte offsets swapped (one of the two must be exact
    to fp32 rounding, the other far off);
  * for chains of 24 and 1000 wgmma k16 steps (6 and 250 products of
    [64 x 64] tiles over 64 channels), the relative error of the
    tensor-core sum against the exact sum, as its mean (the bias) and
    standard deviation over 64 x 64 x 64 sums: in one chain, in chains of
    one product (4 steps, one 64-key tile of the attention core) joined by
    fp32 round-to-nearest adds, and by PyTorch in fp32;
  * the bf16 rate (TFLOP/s) of chained m64n64k16 wgmma from shared memory,
    8 warpgroups per SM.
The chain operands are bf16, uniform in [0.5, 1) (every product positive,
as P*V's weights are), so every product is exact and only the
accumulation errs.
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np


def main():
    import torch

    from gta_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        raise SystemExit("probe_wgmma needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _cuda.load("wgmma_probe")
    for line in _cuda.BUILD_LOGS.get("wgmma_probe", "").splitlines():
        if "registers" in line or "spill" in line or "error" in line or "arning" in line:
            print(f"nvcc wgmma_probe: {line.strip()}", flush=True)
    lib.wgmma_probe_layout.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.wgmma_probe_chain.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    dev = torch.device("cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731

    def check(err):
        if err != 0:
            raise RuntimeError(f"probe launch failed with cudaError {err}")

    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for C in (64, 96):
        a, b, v = (torch.randn((64, C), generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
        s_ref = a.double() @ b.double().T
        for swap in (0, 1):
            S = torch.full((64, 64), float("nan"), device=dev)
            O = torch.full((64, C), float("nan"), device=dev)
            check(lib.wgmma_probe_layout(ptr(a), ptr(b), ptr(v), ptr(S), ptr(O), C, swap, stream))
            torch.cuda.synchronize()
            ds = (S.double() - s_ref).abs().max().item()
            o_ref = S.to(torch.bfloat16).double() @ v.double()  # O's operand is the kernel's own S, rounded
            do = (O.double() - o_ref).abs().max().item()
            label = "swapped" if swap else "as built"
            print(f"layout C={C} MN-major offsets {label}: max|S - fp64| {ds:.3e} (|S| max "
                  f"{s_ref.abs().max().item():.1f}), max|O - fp64| {do:.3e}", flush=True)
            if not swap:
                ok = ok and ds < 1e-3 and do < 2e-2

    rng = np.random.RandomState(0)
    blocks = 64
    for steps in (24, 1000):
        reps = steps // 4
        A = torch.from_numpy(rng.uniform(0.5, 1.0, (blocks, 64, 64)).astype(np.float32)).to(dev).to(torch.bfloat16)
        B = torch.from_numpy(rng.uniform(0.5, 1.0, (blocks, 64, 64)).astype(np.float32)).to(dev).to(torch.bfloat16)
        exact = torch.einsum("zmk,znk->zmn", A.double(), B.double()) * reps
        fp32 = torch.zeros((blocks, 64, 64), device=dev)
        one = torch.einsum("zmk,znk->zmn", A.float(), B.float())
        for _ in range(reps):
            fp32 += one
        cols = []
        for join in (0, 1):
            D = torch.empty((blocks, 64, 64), device=dev)
            check(lib.wgmma_probe_chain(ptr(A), ptr(B), ptr(D), blocks, reps, join, stream))
            cols.append(D)
        torch.cuda.synchronize()

        def stats(x):
            r = (x.double() - exact) / exact
            return f"bias {r.mean().item():+.3e} sd {r.std().item():.3e}"

        print(f"chain of {steps} k16 steps ({reps} products): one wgmma chain {stats(cols[0])}; chains of one "
              f"product + fp32 adds {stats(cols[1])}; PyTorch fp32 adds of the products {stats(fp32)}", flush=True)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, reps = 8 * sms, 2048
    A = torch.rand((blocks, 64, 64), generator=gen, device=dev).to(torch.bfloat16)
    D = torch.empty((blocks, 64, 64), device=dev)
    check(lib.wgmma_probe_chain(ptr(A), ptr(A), ptr(D), blocks, 8, 0, stream))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    check(lib.wgmma_probe_chain(ptr(A), ptr(A), ptr(D), blocks, reps, 0, stream))
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    flops = 2.0 * blocks * reps * 64 * 64 * 64
    print(f"wgmma m64n64k16 bf16, 8 warpgroups per SM, a wait after every 4 steps: "
          f"{flops / ms / 1e9:.1f} TFLOP/s ({ms:.4f} ms)", flush=True)
    if not ok:
        raise SystemExit("probe_wgmma: the products as the kernels build them disagree with fp64")


if __name__ == "__main__":
    main()
