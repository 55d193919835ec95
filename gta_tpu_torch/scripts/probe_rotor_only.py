"""Where the bf16 fused GTA forward at the DiT's rotor-only tables departs
from the TPU kernel's rounding: the output's error split by span and by
stage.

Usage (one CUDA card), from the repository root:
    python -m gta_tpu_torch.scripts.probe_rotor_only

The draw of tests/test_torch_cuda.py
`test_gta_fused_bf16_rotor_only_one_view_error_against_fp64` (dit_gta's
attention: 2 items, 6 heads of 64 (triv 32, so2 32 with 8 frequencies),
one view of 16 x 16 patch tokens, rotor tables only; N(0, 1) rows, seed
14, with a common component of 0 and of 8x their spread). For z (the
attention output before the inverse rotors) and out, the relative L2
error against the plain version in fp64 on the same bf16 inputs, over the
trivial lanes, the rotor lanes and all, of:
  * kernel: the bf16 CUDA forward;
  * tpu: the bf16 emulation (the plain version with mxu_dtype=bf16): the
    TPU kernel's rounding, which rotates the fp32 z and rounds once;
  * z rounded first: the emulation's z rounded to bf16, then rotated in
    fp32 and rounded again.
The kernel's out sits at `tpu` where it rounds where the TPU kernel
rounds, at `z rounded first` where it rotates a rounded z.
"""

from __future__ import annotations

import subprocess


def main():
    import torch

    from gta_tpu_torch.config import AttnConfig, FDims, GTAArgs
    from gta_tpu_torch.models.dit import DiTConfig, grid_reps
    from gta_tpu_torch.ops import gta_fused as tgf

    if not torch.cuda.is_available():
        raise SystemExit("probe_rotor_only needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, bf = torch.device("cuda"), torch.bfloat16
    B, H, C, T = 2, 6, 64, 256
    args = GTAArgs(f_dims=FDims(triv=32, so2=32), so2=8)
    lanes = {"triv": slice(0, 32), "so2": slice(32, 64), "all": slice(0, 64)}

    def rel(a, r, span):
        a = a.double().reshape(B, T, H, C)[..., lanes[span]]
        r = r.reshape(B, T, H, C)[..., lanes[span]]
        return ((a - r).norm() / r.norm()).item()

    for common in (0.0, 8.0):
        gen = torch.Generator(device=dev).manual_seed(14)
        q, k, v, _ = (torch.randn((B, T, H * C), generator=gen, device=dev) for _ in range(4))
        for x in (q, k, v):
            x += common * torch.randn((B, 1, H * C), generator=gen, device=dev)
        q, k, v = (x.to(bf) for x in (q, k, v))
        with torch.no_grad():
            t = tgf.fused_tables(grid_reps(DiTConfig(attn=AttnConfig(method="gta", gta=args)), B, dev), args, None)
            out, res = tgf.gta_fused_fwd(q, k, v, t, H, C**-0.5, residuals=True)
            emu_out, emu_z = tgf.gta_fused_fwd_plain(q, k, v, t, H, C**-0.5, store_z=True, mxu_dtype=bf)
            t64 = tgf.FusedTables(*[None if x is None else x.double() for x in tgf._tables(t)], t.nq, t.nk,
                                  t.v_transform)
            ref_out, ref_z = tgf.gta_fused_fwd_plain(q.double(), k.double(), v.double(), t64, H, C**-0.5,
                                                     store_z=True)
            # the emulation's z rounded to bf16, rotated by the inverse rotors in fp32, rounded again
            P = tgf._Plain(B, H, C, torch.float32, None)
            twice = P.tokens(P.rot(P.heads_first(emu_z.float(), T), t.cq, t.sq, -1.0)).to(bf)
        for name, got, ref in (("z", {"kernel": res.z, "tpu": emu_z}, ref_z),
                               ("out", {"kernel": out, "tpu": emu_out, "z rounded first": twice}, ref_out)):
            print(f"common {common:g}, {name}: " + "; ".join(
                f"{who} " + " / ".join(f"{span} {rel(x, ref, span):.4e}" for span in lanes) for who, x in got.items()),
                flush=True)


if __name__ == "__main__":
    main()
