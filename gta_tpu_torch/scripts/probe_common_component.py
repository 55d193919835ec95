"""How far the fused GTA kernels' outputs are from fp64 when q, k and v rows
share a large component, as a layer's tokens do, stage by stage.

Usage (one CUDA card):
    python -m gta_tpu_torch.scripts.probe_common_component

The draw of tests/test_torch_cuda.py `_common_component_errors`, in each of
its cases (se3 64 with 6 heads at 1 and 2 views; msn_so3's se3 48 + so3 24
+ so2 24 with 8 heads of 96 at 1, 2 and 5 views; 600 tokens): a common
component of 8x the rows' spread added to every raw q, k and v row of a
batch. For each stage of the fp32 kernels, the relative L2 error against
the plain version in fp64, beside the same error of the plain version in
fp32 on the card:
  * the core: dzq, dzk, dzv, the attention core's dqt, dkt, dvt after the
    inverse rotors (an orthogonal map: the same relative error), and dz;
  * the chains: dq, dk, dv;
  * the matrix cotangents dMq, dMk, dMo, and `-red`, the error of the
    kernel's dM reduction alone: against the same reduction in fp64 of the
    kernel's own chain rows (dzq, dzk, dzv, dz).
A stage whose error is far above the plain version's while its inputs'
are not is where the accuracy goes. The tensor cores truncate each
product's sum by ~1e-6 of its value (csrc/tf32x3.cuh), so a large common
component costs accuracy unless the products are taken about centres
(csrc/attn_core.cuh).
"""

from __future__ import annotations

import subprocess

import numpy as np

CASES = [  # (name, f_dims, so2 freqs, so3 degree, heads, views)
    ("se3_64", dict(se3=64), 0, 0, 6, 1),
    ("se3_64", dict(se3=64), 0, 0, 6, 2),
    ("msn_so3", dict(se3=48, so3=24, so2=24), 6, 2, 8, 1),
    ("msn_so3", dict(se3=48, so3=24, so2=24), 6, 2, 8, 2),
    ("msn_so3", dict(se3=48, so3=24, so2=24), 6, 2, 8, 5),
]
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

    for mix, fd, so2, so3, H, nv in CASES:
        args = GTAArgs(f_dims=FDims(**fd), so2=so2, so3=so3)
        C = args.f_dims.total
        scale = C**-0.5
        rng = np.random.RandomState(0)
        coord = torch.from_numpy(rng.rand(B, nv, T // nv, 2).astype(np.float32)).to(dev)
        tf = torch.from_numpy(np.stack([random_se3(rng, nv) for _ in range(B)])).to(dev)
        reps = encoder_reps(args, coord, tf)
        q, k, v = (torch.from_numpy(rng.randn(B, H, T, C).astype(np.float32)).transpose(1, 2)
                   .reshape(B, T, H * C).contiguous().to(dev) for _ in range(3))
        gen = torch.Generator(device=dev).manual_seed(8)
        for x in (q, k, v):
            x += 8 * torch.randn((B, 1, H * C), generator=gen, device=dev)
        g = torch.randn(q.shape, generator=gen, device=dev)
        with torch.no_grad():
            t = tgf.fused_tables(reps, args, torch.tensor([0.3], device=dev))
            out, res = tgf.gta_fused_fwd(q, k, v, t, H, scale, residuals=True)
            mids, mids32, mids64 = {}, {}, {}
            got = tgf.gta_fused_bwd(q, k, v, t, H, scale, g, res, keep=mids)
            plain = tgf.gta_fused_bwd_plain(q, k, v, t, H, scale, g, res.z, keep=mids32)
            t64 = tgf.FusedTables(*[None if x is None else x.double() for x in tgf._tables(t)],
                                  t.nq, t.nk, t.v_transform)
            q64, k64, v64 = q.double(), k.double(), v.double()
            o64, z64 = tgf.gta_fused_fwd_plain(q64, k64, v64, t64, H, scale, store_z=True)
            ref = tgf.gta_fused_bwd_plain(q64, k64, v64, t64, H, scale, g.double(), z64, keep=mids64)
            P = tgf._Plain(B, H, C, torch.float64, None)

            def dmat(x, y, n):  # the dM reduction in fp64 of the kernel's rows
                return P.dmat(P.heads_first(x.double(), T), P.heads_first(y.double(), T), n)

            line = [f"out {rel(out, o64):.2e}/{rel(tgf.gta_fused_fwd_plain(q, k, v, t, H, scale), o64):.2e}"]
            for name in ("dzq", "dzk", "dzv", "dz"):
                if mids.get(name) is not None and mids64.get(name) is not None:
                    line.append(f"{name} {rel(mids[name], mids64[name]):.2e}/{rel(mids32[name], mids64[name]):.2e}")
            red = {
                "dmq": dmat(q, mids["dzq"], t.nq),
                "dmk": dmat(k, mids["dzk"], t.nk) + dmat(v, mids["dzv"], t.nk),
                "dmo": dmat(res.z, mids["dz"], t.nq),
            }
            for name, a, b, r in zip(("dq", "dk", "dv", "dmq", "dmk", "dmo"), got, plain, ref):
                line.append(f"{name} {rel(a, r):.2e}/{rel(b, r):.2e}")
                if name in red:
                    line.append(f"{name}-red {rel(a, red[name]):.2e}")
        print(f"{mix} C={C} views={nv}: kernel/plain-fp32 relative L2 vs fp64: " + "  ".join(line), flush=True)


if __name__ == "__main__":
    main()
