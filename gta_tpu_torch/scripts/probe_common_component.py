"""How far the fused GTA kernels' outputs are from fp64 when q, k and v rows
share a large component, as a layer's tokens do.

Usage (one CUDA card):
    python -m gta_tpu_torch.scripts.probe_common_component

For each rep mix (se3 64 with no rotors, the flagship's se3 32 + so2 32,
msn_so3's se3 48 + so3 24 + so2 24 at head width 96), 1, 2 and 5 views of
600 tokens, and a common component of 0 or 8x the rows' spread added to
every raw q, k and v row of a batch: the relative L2 error against the
plain version in fp64 of the kernels' out and each backward output (dq,
dk, dv, dMq, dMk, dMo), beside the same error of the plain version in
fp32 on the card. The tensor cores truncate each product's sum by ~1e-6
of its value (csrc/tf32x3.cuh), so a large common component costs accuracy
unless the core centres its products (csrc/attn_core.cuh, CENTER).
"""

from __future__ import annotations

import subprocess

import numpy as np

MIXES = {  # name -> (f_dims, so2 freqs, so3 degree, heads)
    "se3_64": (dict(se3=64), 0, 0, 6),
    "clevr": (dict(se3=32, so2=32), 8, 0, 6),
    "msn_so3": (dict(se3=48, so3=24, so2=24), 6, 2, 8),
}
B, T = 2, 600


def random_se3(rng, n):
    """[n, 4, 4] rigid transforms: QR rotations (det +1), normal translations."""
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[:, None, :]
    q[:, :, 0] *= np.linalg.det(q)[:, None]
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :3], out[:, :3, 3] = q, rng.normal(size=(n, 3))
    return out.astype(np.float32)


def main():
    import torch

    from gta_tpu_torch.config import FDims, GTAArgs
    from gta_tpu_torch.ops import gta_fused as tgf
    from gta_tpu_torch.ops.reps import encoder_reps

    if not torch.cuda.is_available():
        raise SystemExit("probe_common_component needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def rel(a, r):
        return ((a.double() - r).norm() / r.norm()).item()

    for nv in (1, 2, 5):
        for mix, (fd, so2, so3, H) in MIXES.items():
            args = GTAArgs(f_dims=FDims(**fd), so2=so2, so3=so3)
            C = args.f_dims.total
            scale = C**-0.5
            for common in (0.0, 8.0):
                rng = np.random.RandomState(0)
                coord = torch.from_numpy(rng.rand(B, nv, T // nv, 2).astype(np.float32)).to(dev)
                tf = torch.from_numpy(np.stack([random_se3(rng, nv) for _ in range(B)])).to(dev)
                reps = encoder_reps(args, coord, tf)
                q, k, v, g = (torch.from_numpy(rng.randn(B, T, H * C).astype(np.float32)).to(dev) for _ in range(4))
                for x in (q, k, v):
                    x += common * torch.from_numpy(rng.randn(B, 1, H * C).astype(np.float32)).to(dev)
                with torch.no_grad():
                    t = tgf.fused_tables(reps, args, torch.tensor([0.3], device=dev))
                    out, res = tgf.gta_fused_fwd(q, k, v, t, H, scale, residuals=True)
                    got = tgf.gta_fused_bwd(q, k, v, t, H, scale, g, res)
                    plain = tgf.gta_fused_bwd_plain(q, k, v, t, H, scale, g, res.z)
                    t64 = tgf.FusedTables(*[None if x is None else x.double() for x in tgf._tables(t)],
                                          t.nq, t.nk, t.v_transform)
                    o64, z64 = tgf.gta_fused_fwd_plain(q.double(), k.double(), v.double(), t64, H, scale,
                                                       store_z=True)
                    ref = tgf.gta_fused_bwd_plain(q.double(), k.double(), v.double(), t64, H, scale,
                                                  g.double(), z64)
                    line = [f"out {rel(out, o64):.2e}/{rel(tgf.gta_fused_fwd_plain(q, k, v, t, H, scale), o64):.2e}"]
                    for name, a, b, r in zip(("dq", "dk", "dv", "dmq", "dmk", "dmo"), got, plain, ref):
                        if r is not None:
                            line.append(f"{name} {rel(a, r):.2e}/{rel(b, r):.2e}")
                print(f"views={nv} {mix} C={C} common={common}: kernel/plain-fp32 relative L2 vs fp64: "
                      + "  ".join(line), flush=True)


if __name__ == "__main__":
    main()
