"""How far flash_core's bf16 backward would be from fp64 if it took
delta = rowsum(g * o) from the forward's bf16 output o in place of the TPU
kernel's delta = rowsum(P * dP), which the kernel's query pass computes
from its own products in a first sweep over the keys.

Usage (one CUDA card):
    python -m gta_tpu_torch.scripts.probe_delta_from_o

The plain versions on the card, with the TPU kernel's rounding
(`mxu_dtype=bf16`: every product's operands rounded to bf16, fp32 sums),
at the draws of tests/test_torch_cuda.py's
`test_flash_core_bf16_error_against_fp64` (self 600 x 600, cross 2560 x
600, and cross with keys and values that share a component of 8x their
spread; 6 heads of 64): each backward output's relative L2 error against
the plain version in fp64, with either delta, and their ratio. The card
tests hold a bf16 kernel to 1.5x the TPU formula's error, so a ratio
above 1.5 rules the other formula out. Prints the card's name and power
limit first.
"""

from __future__ import annotations

import subprocess

C = 64  # flash_core's head width
BF16_RULE = 1.5


def rel_l2(a, r) -> float:
    den = r.double().norm().item()
    diff = (a.double() - r.double()).norm().item()
    return diff / den if den > 0 else diff


def bwd_delta_from_o(q, k, v, g, o, heads, mxu_dtype):
    """The plain backward with the TPU kernel's rounding (`mxu_dtype`), but
    delta = rowsum(g * o) in fp32 from the forward's output o."""
    import torch

    from gta_tpu_torch.ops import flash_core as fc

    work = torch.float32
    scale = C**-0.5
    qh, kh, vh, gh, oh = (fc.split_heads(x, heads) for x in (q, k, v, g, o))
    p = torch.softmax(fc._dot("bhqc,bhkc->bhqk", qh, kh, work, mxu_dtype) * scale, dim=-1)
    dp = fc._dot("bhqc,bhkc->bhqk", gh, vh, work, mxu_dtype)
    delta = (gh.float() * oh.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = fc._dot("bhqk,bhkc->bhqc", ds, kh, work, mxu_dtype)
    dk = fc._dot("bhqk,bhqc->bhkc", ds, qh, work, mxu_dtype)
    dv = fc._dot("bhqk,bhqc->bhkc", p, gh, work, mxu_dtype)
    return fc.merge_heads(dq), fc.merge_heads(dk), fc.merge_heads(dv)


def main():
    import torch

    from gta_tpu_torch.ops import flash_core as fc

    if not torch.cuda.is_available():
        raise SystemExit("probe_delta_from_o needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    bf, scale, B, H = torch.bfloat16, C**-0.5, 2, 6
    for name, tq, tk, common in (("self", 600, 600, 0.0), ("cross", 2560, 600, 0.0),
                                 ("cross-common-component", 2560, 600, 8.0)):
        gen = torch.Generator(device=dev).manual_seed(12)
        q, k, v, g = (torch.randn((B, t, H * C), generator=gen, device=dev) for t in (tq, tk, tk, tq))
        gen = torch.Generator(device=dev).manual_seed(13)
        k = k + common * torch.randn((B, 1, H * C), generator=gen, device=dev)
        v = v + common * torch.randn((B, 1, H * C), generator=gen, device=dev)
        q, k, v, g = (x.to(bf) for x in (q, k, v, g))
        with torch.no_grad():
            ref = fc.flash_core_bwd_plain(*(x.double() for x in (q, k, v)), H, scale, g.double())
            sweep = fc.flash_core_bwd_plain(q, k, v, H, scale, g, mxu_dtype=bf)
            o = fc.flash_core_fwd_plain(q, k, v, H, scale, mxu_dtype=bf)  # bf16, as the kernel writes it
            from_o = bwd_delta_from_o(q, k, v, g, o, H, bf)
        for out, a, b, r in zip(("dq", "dk", "dv"), sweep, from_o, ref):
            e_sweep, e_o = rel_l2(a, r), rel_l2(b, r)
            print(f"delta {name} {out}: relative L2 vs fp64, delta = rowsum(P * dP) {e_sweep:.3e}, "
                  f"delta = rowsum(g * o) {e_o:.3e}, ratio {e_o / e_sweep:.2f} (rule {BF16_RULE})", flush=True)


if __name__ == "__main__":
    main()
