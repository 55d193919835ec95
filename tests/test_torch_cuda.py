"""The port's CUDA kernels on the card, against their plain PyTorch versions
and fp64: the fused GTA forward and backward, and flash_core forward and
backward, each in its fp32 instance and its bf16 one, at head widths 64 and
96 (the bf16 instances held to 1.5x the error of the TPU kernel's rounding,
the plain version with mxu_dtype=bf16).

A CUDA kernel has no CPU mode, so every test here is marked `cuda` and skips
without a card. The file imports only torch, numpy and the port, so it runs
on a GPU machine that has no flax:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from gta_tpu_torch.config import AttnConfig, FDims, GTAArgs
from gta_tpu_torch.ops import _cuda, flash_core as fc, gta_fused as tgf
from gta_tpu_torch.ops.reps import decoder_reps, encoder_reps

B, H, C = 2, 6, 64
SCALE = C**-0.5


def random_se3(rng, n):
    """[n, 4, 4] rigid transforms: QR rotations (det +1), normal translations.
    Kept here so the file needs nothing beyond the port on a GPU machine."""
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[:, None, :]
    q[:, :, 0] *= np.linalg.det(q)[:, None]
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :3], out[:, :3, 3] = q, rng.normal(size=(n, 3))
    return out.astype(np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _fused(q, k, v, reps, args, tc, scale=SCALE):
    """The layer's token-major entry, called with [B, H, T, C] operands."""
    heads = q.shape[1]

    def tokens(x):
        return x.transpose(1, 2).reshape(B, x.shape[2], -1)

    out = tgf.fused_gta_attention_tokens(tokens(q), tokens(k), tokens(v), heads, reps, args, tc, scale)
    return out.reshape(B, q.shape[2], heads, -1).transpose(1, 2)


def _inputs(rng, args, device, tq=600, tk=600, nv=2, heads=H):
    coord = torch.from_numpy(rng.rand(B, nv, tk // nv, 2).astype(np.float32))
    tf = torch.from_numpy(np.stack([random_se3(rng, nv) for _ in range(B)]))
    reps = encoder_reps(args, coord.to(device), tf.to(device))
    cpu_reps = encoder_reps(args, coord, tf)
    if tq != tk:  # decoder cross-attention: 3 target views against the encoder's keys
        t_coord = torch.from_numpy(rng.rand(B, 3, tq // 3, 2).astype(np.float32))
        t_tf = torch.from_numpy(np.stack([random_se3(rng, 3) for _ in range(B)]))

        def dec(enc, dev):
            return decoder_reps(
                args, target_coord=t_coord.to(dev), target_transforms=t_tf.to(dev),
                input_coord=coord.to(dev), input_transforms=tf.to(dev), enc=enc,
            )

        reps, cpu_reps = dec(reps, device), dec(cpu_reps, "cpu")
    C = args.f_dims.total
    qkv = [torch.from_numpy(rng.randn(B, heads, t, C).astype(np.float32)) for t in (tq, tk, tk)]
    return reps, cpu_reps, qkv


def _tokens(x):
    return x.transpose(1, 2).reshape(B, x.shape[2], -1).contiguous()


BRANCHES = [
    (dict(se3=32, so2=32), 8, True),
    (dict(so2=64), 16, True),
    (dict(se3=64), 0, True),
    (dict(triv=16, se3=16, so2=32), 8, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("fd,so2,vt", BRANCHES)
def test_gta_fused_fwd_matches_plain(rng, cuda_device, fd, so2, vt):
    """Every flag branch at C = 64, 300-token views (off any tile grid) and
    a ragged last K tile; atol 1e-4: the order of summation over 600 keys
    differs from the plain version's."""
    args = GTAArgs(f_dims=FDims(**fd), so2=so2, v_transform=vt)
    reps, cpu_reps, (q, k, v) = _inputs(rng, args, cuda_device)
    tc = torch.tensor([0.01])
    with torch.no_grad():
        before = tgf.gta_fused_fwd.launches
        got = _fused(q.to(cuda_device), k.to(cuda_device), v.to(cuda_device), reps, args, tc.to(cuda_device))
        torch.cuda.synchronize()
        assert tgf.gta_fused_fwd.launches == before + 1
        want = _fused(q, k, v, cpu_reps, args, tc)
    assert (got.cpu() - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [600, 192])
@pytest.mark.parametrize("fd,so2,vt", BRANCHES)
def test_gta_fused_bwd_matches_plain(rng, cuda_device, fd, so2, vt, tq):
    """The backward kernel against its plain version on the same card
    inputs, every flag branch at C = 64 with 300-token key views (and
    3 x 64-ray query views for tq = 192). Each output within
    1e-4 * max(1, max|plain|): fp32, the order of summation over keys,
    queries and (row, head) pairs differs."""
    args = GTAArgs(f_dims=FDims(**fd), so2=so2, v_transform=vt)
    reps, _, (q, k, v) = _inputs(rng, args, cuda_device, tq=tq)
    qB, kB, vB = (_tokens(x).to(cuda_device) for x in (q, k, v))
    with torch.no_grad():
        t = tgf.fused_tables(reps, args, torch.tensor([0.3], device=cuda_device))
        _, res = tgf.gta_fused_fwd(qB, kB, vB, t, H, SCALE, residuals=True)
        g = torch.randn(qB.shape, generator=torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
        before = tgf.gta_fused_bwd.launches
        got = tgf.gta_fused_bwd(qB, kB, vB, t, H, SCALE, g, res)
        torch.cuda.synchronize()
        assert tgf.gta_fused_bwd.launches == before + 1
        want = tgf.gta_fused_bwd_plain(qB, kB, vB, t, H, SCALE, g, res.z)
    for name, a, b in zip(("dq", "dk", "dv", "dmq", "dmk", "dmo"), got, want):
        assert (a is None) == (b is None), name
        if b is not None:
            tol = 1e-4 * max(1.0, b.abs().max().item())
            assert (a - b).abs().max().item() <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [600, 192])
def test_gta_fused_bwd_error_against_fp64(rng, cuda_device, tq):
    """The kernel and the fp32 plain version against the plain version in
    fp64, as relative L2 errors per output: a row dropped from or counted
    twice in a sum over 600 keys, 2568 queries or 1800 (row, head) pairs
    would show as ~1e-3; fp32 rounding stays near 1e-6."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = GTAArgs(f_dims=FDims(se3=32, so2=32), so2=8)
    reps, _, (q, k, v) = _inputs(rng, args, cuda_device, tq=tq)
    qB, kB, vB = (_tokens(x).to(cuda_device) for x in (q, k, v))
    with torch.no_grad():
        t = tgf.fused_tables(reps, args, torch.tensor([0.3], device=cuda_device))
        _, res = tgf.gta_fused_fwd(qB, kB, vB, t, H, SCALE, residuals=True)
        g = torch.randn(qB.shape, generator=torch.Generator(device=cuda_device).manual_seed(1), device=cuda_device)
        got = tgf.gta_fused_bwd(qB, kB, vB, t, H, SCALE, g, res)
        plain = tgf.gta_fused_bwd_plain(qB, kB, vB, t, H, SCALE, g, res.z)
        t64 = tgf.FusedTables(*[None if x is None else x.double() for x in tgf._tables(t)], t.nq, t.nk, t.v_transform)
        _, z64 = tgf.gta_fused_fwd_plain(qB.double(), kB.double(), vB.double(), t64, H, SCALE, store_z=True)
        ref = tgf.gta_fused_bwd_plain(qB.double(), kB.double(), vB.double(), t64, H, SCALE, g.double(), z64)
    for name, a, b, r in zip(("dq", "dk", "dv", "dmq", "dmk", "dmo"), got, plain, ref):
        err_kernel = ((a.double() - r).norm() / r.norm()).item()
        err_plain = ((b.double() - r).norm() / r.norm()).item()
        assert err_kernel <= 1e-5, (name, err_kernel, err_plain)


def _edge_inputs(rng, args, device, tq, tk, heads=H):
    """Decoder-style reps with one view on each side (Tq target rays against
    Tk input tokens) and token-major q, k, v, g on the card."""
    coord = torch.from_numpy(rng.rand(B, 1, tk, 2).astype(np.float32)).to(device)
    tf = torch.from_numpy(np.stack([random_se3(rng, 1) for _ in range(B)])).to(device)
    t_coord = torch.from_numpy(rng.rand(B, 1, tq, 2).astype(np.float32)).to(device)
    t_tf = torch.from_numpy(np.stack([random_se3(rng, 1) for _ in range(B)])).to(device)
    reps = decoder_reps(
        args, target_coord=t_coord, target_transforms=t_tf, input_coord=coord, input_transforms=tf,
        enc=encoder_reps(args, coord, tf),
    )
    D = heads * args.f_dims.total
    q, k, v, g = (torch.from_numpy(rng.randn(B, t, D).astype(np.float32)).to(device) for t in (tq, tk, tk, tq))
    return reps, q, k, v, g


EDGE_BRANCHES = [
    (dict(se3=32, so2=32), 8, True),  # every transform, v_transform
    (dict(triv=64), 0, True),  # no table: raw token-major q, k, v
]


@pytest.mark.cuda
@pytest.mark.parametrize("fd,so2,vt", EDGE_BRANCHES)
@pytest.mark.parametrize("tq", [1, 17, 601])
@pytest.mark.parametrize("tk", [1, 33, 2100])
def test_gta_fused_kernels_match_plain_at_edge_shapes(rng, cuda_device, fd, so2, vt, tq, tk):
    """One query or key, a ragged last 16-row warp tile and 64-key tile on
    either side (17, 601 rows; 33 keys) and more keys than the Pallas kernel
    holds in VMEM (2100), one view per side: out and z within atol 1e-4,
    each backward output within 1e-4 * max(1, max|plain|) (fp32; the order
    of summation differs)."""
    args = GTAArgs(f_dims=FDims(**fd), so2=so2, v_transform=vt)
    reps, q, k, v, g = _edge_inputs(rng, args, cuda_device, tq, tk)
    with torch.no_grad():
        t = tgf.fused_tables(reps, args, torch.tensor([0.3], device=cuda_device))
        fwd, bwd = tgf.gta_fused_fwd.launches, tgf.gta_fused_bwd.launches
        out, res = tgf.gta_fused_fwd(q, k, v, t, H, SCALE, residuals=True)
        got = tgf.gta_fused_bwd(q, k, v, t, H, SCALE, g, res)
        torch.cuda.synchronize()
        assert (tgf.gta_fused_fwd.launches - fwd, tgf.gta_fused_bwd.launches - bwd) == (1, 1)
        want_out, want_z = tgf.gta_fused_fwd_plain(q, k, v, t, H, SCALE, store_z=True)
        want = tgf.gta_fused_bwd_plain(q, k, v, t, H, SCALE, g, res.z)
    assert (out - want_out).abs().max().item() <= 1e-4
    assert (res.z - want_z).abs().max().item() <= 1e-4
    for name, a, b in zip(("dq", "dk", "dv", "dmq", "dmk", "dmo"), got, want):
        assert (a is None) == (b is None), name
        if b is not None:
            assert (a - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max().item()), name


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [600, 192])
def test_gta_fused_fwd_error_against_fp64(rng, cuda_device, tq):
    """The forward kernel's out and z against the plain version in fp64, as
    relative L2 errors: fp32 accuracy keeps them near 1e-6, a single TF32
    pass (10-bit operands) would give ~1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = GTAArgs(f_dims=FDims(se3=32, so2=32), so2=8)
    reps, _, (q, k, v) = _inputs(rng, args, cuda_device, tq=tq)
    qB, kB, vB = (_tokens(x).to(cuda_device) for x in (q, k, v))
    with torch.no_grad():
        t = tgf.fused_tables(reps, args, torch.tensor([0.3], device=cuda_device))
        out, res = tgf.gta_fused_fwd(qB, kB, vB, t, H, SCALE, residuals=True)
        t64 = tgf.FusedTables(*[None if x is None else x.double() for x in tgf._tables(t)], t.nq, t.nk, t.v_transform)
        ref_out, ref_z = tgf.gta_fused_fwd_plain(qB.double(), kB.double(), vB.double(), t64, H, SCALE, store_z=True)
    for name, a, r in (("out", out, ref_out), ("z", res.z, ref_z)):
        assert ((a.double() - r).norm() / r.norm()).item() <= 1e-5, name


@pytest.mark.cuda
def test_gta_fused_bwd_is_deterministic(rng, cuda_device):
    """Two backward launches on the same inputs give bit-identical outputs:
    every row is owned by one warp and every sum has a fixed order."""
    args = GTAArgs(f_dims=FDims(se3=32, so2=32), so2=8)
    reps, _, (q, k, v) = _inputs(rng, args, cuda_device, tq=192)
    qB, kB, vB = (_tokens(x).to(cuda_device) for x in (q, k, v))
    with torch.no_grad():
        t = tgf.fused_tables(reps, args, torch.tensor([0.3], device=cuda_device))
        _, res = tgf.gta_fused_fwd(qB, kB, vB, t, H, SCALE, residuals=True)
        g = torch.randn(qB.shape, generator=torch.Generator(device=cuda_device).manual_seed(2), device=cuda_device)
        first = tgf.gta_fused_bwd(qB, kB, vB, t, H, SCALE, g, res)
        second = tgf.gta_fused_bwd(qB, kB, vB, t, H, SCALE, g, res)
    for name, a, b in zip(("dq", "dk", "dv", "dmq", "dmk", "dmo"), first, second):
        assert a is not None, name
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_function_grads_on_card_match_cpu(rng, cuda_device):
    """GTAFusedAttention's gradients (q, k, v, trans_coeff) through both
    kernels on the card against the plain versions on the CPU."""
    args = GTAArgs(f_dims=FDims(se3=32, so2=32), so2=8)
    reps, cpu_reps, (q, k, v) = _inputs(rng, args, cuda_device, tq=192)
    g = torch.from_numpy(rng.randn(B, 192, H * C).astype(np.float32))
    grads = {}
    for dev, r in (("cpu", cpu_reps), (cuda_device, reps)):
        leaves = [_tokens(x).to(dev).requires_grad_() for x in (q, k, v)]
        tc = torch.tensor([0.01], device=dev, requires_grad=True)
        fwd, bwd = tgf.gta_fused_fwd.launches, tgf.gta_fused_bwd.launches
        out = tgf.fused_gta_attention_tokens(*leaves, H, r, args, tc, SCALE)
        out.backward(g.to(dev))
        launched = (tgf.gta_fused_fwd.launches - fwd, tgf.gta_fused_bwd.launches - bwd)
        assert launched == ((0, 0) if dev == "cpu" else (1, 1))
        grads[str(dev)] = [x.grad.cpu() for x in leaves + [tc]]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max().item())


@pytest.mark.cuda
def test_gta_fused_fwd_raises_instead_of_falling_back(rng, cuda_device):
    args = GTAArgs(f_dims=FDims(se3=32, so2=32), so2=8)
    reps, _, (q, k, v) = _inputs(rng, args, cuda_device)
    q, k, v = (x.to(cuda_device) for x in (q, k, v))
    tc = torch.tensor([0.01], device=cuda_device, requires_grad=True)
    fwd, bwd = tgf.gta_fused_fwd.launches, tgf.gta_fused_bwd.launches
    _fused(q, k, v, reps, args, tc).sum().backward()
    assert (tgf.gta_fused_fwd.launches - fwd, tgf.gta_fused_bwd.launches - bwd) == (1, 1)
    narrow = GTAArgs(f_dims=FDims(se3=16, so2=16), so2=4)
    reps32, _, (q32, k32, v32) = _inputs(rng, narrow, cuda_device)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="head dim"):
        _fused(q32[..., :32].to(cuda_device), k32[..., :32].to(cuda_device), v32[..., :32].to(cuda_device),
               reps32, narrow, None)


@pytest.mark.cuda
def test_gta_fused_bwd_raises_on_uncovered_operands(rng, cuda_device):
    """Head width 32, non-contiguous and fp64 operands raise; nothing falls
    back to the plain version."""
    args = GTAArgs(f_dims=FDims(se3=32, so2=32), so2=8)
    reps, _, (q, k, v) = _inputs(rng, args, cuda_device)
    qB, kB, vB = (_tokens(x).to(cuda_device) for x in (q, k, v))
    with torch.no_grad():
        t = tgf.fused_tables(reps, args, torch.tensor([0.01], device=cuda_device))
        _, res = tgf.gta_fused_fwd(qB, kB, vB, t, H, SCALE, residuals=True)
        g = torch.ones_like(qB)
        before = tgf.gta_fused_bwd.launches
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 3"):
            tgf.gta_fused_bwd(qB, kB, vB, t, 2 * H, SCALE, g, res)
        with pytest.raises(ValueError, match="contiguous fp32"):
            tgf.gta_fused_bwd(qB, kB, vB, t, H, SCALE, g.transpose(1, 2).contiguous().transpose(1, 2), res)
        with pytest.raises(ValueError, match="contiguous fp32"):
            tgf.gta_fused_bwd(qB.double(), kB, vB, t, H, SCALE, g, res)
        assert tgf.gta_fused_bwd.launches == before


def _fp64_errors(qB, kB, vB, t, heads, scale, g):
    """Relative L2 errors against the plain versions in fp64 of the kernels'
    (out, z, dq, dk, dv, dmq, dmk, dmo) and of the plain versions' in fp32
    on the card, each by name (absent outputs left out)."""
    out, res = tgf.gta_fused_fwd(qB, kB, vB, t, heads, scale, residuals=True)
    got = tgf.gta_fused_bwd(qB, kB, vB, t, heads, scale, g, res)
    plain_out, plain_z = tgf.gta_fused_fwd_plain(qB, kB, vB, t, heads, scale, store_z=True)
    plain = tgf.gta_fused_bwd_plain(qB, kB, vB, t, heads, scale, g, plain_z)
    t64 = tgf.FusedTables(*[None if x is None else x.double() for x in tgf._tables(t)], t.nq, t.nk, t.v_transform)
    q64, k64, v64 = qB.double(), kB.double(), vB.double()
    ref_out, ref_z = tgf.gta_fused_fwd_plain(q64, k64, v64, t64, heads, scale, store_z=True)
    ref = tgf.gta_fused_bwd_plain(q64, k64, v64, t64, heads, scale, g.double(), ref_z)
    names = ("out", "z", "dq", "dk", "dv", "dmq", "dmk", "dmo")

    def rel(values):
        return {name: ((a.double() - r).norm() / r.norm()).item()
                for name, a, r in zip(names, values, (ref_out, ref_z, *ref)) if r is not None}

    return rel((out, res.z, *got)), rel((plain_out, plain_z, *plain))


# msn_so3's f_dims at head width 96: se3 48, so3 24 (degrees 1-2 x 3), so2 24
MSN_ARGS = GTAArgs(f_dims=FDims(se3=48, so3=24, so2=24), so2=6, so3=2)
MSN_H = 8


def _common_component_errors(rng, device, args, nv):
    """Both kernels' errors against fp64 (and the plain fp32 versions') on
    q, k and v rows that share a component of 8x their spread, as a layer's
    tokens do, 600 tokens in nv views."""
    torch.backends.cuda.matmul.allow_tf32 = False
    heads = H if args.f_dims.total == 64 else MSN_H
    reps, _, (q, k, v) = _inputs(rng, args, device, tq=600, tk=600, nv=nv, heads=heads)
    qB, kB, vB = (_tokens(x).to(device) for x in (q, k, v))
    gen = torch.Generator(device=device).manual_seed(8)
    for x in (qB, kB, vB):
        x += 8 * torch.randn((B, 1, x.shape[-1]), generator=gen, device=device)
    g = torch.randn(qB.shape, generator=gen, device=device)
    with torch.no_grad():
        t = tgf.fused_tables(reps, args, torch.tensor([0.3], device=device))
        return _fp64_errors(qB, kB, vB, t, heads, args.f_dims.total**-0.5, g)


@pytest.mark.cuda
def test_gta_fused_bwd_error_against_fp64_with_common_component(rng, cuda_device):
    """One view, se3 64 and no rotors (gta_no2demb's rows): a per-view
    transform keeps a token-common component common, and the tensor cores
    truncate each product's sum by ~1e-6 of its value, so the core takes
    its products about the key and value rows' means (csrc/attn_core.cuh).
    Every output within 1e-5 relative L2 of fp64 (with no centres dq was
    8.8e-5 and dMq 1.3e-4 here; the plain version in fp32 on the card is
    ~2e-5)."""
    errs, plain = _common_component_errors(rng, cuda_device, GTAArgs(f_dims=FDims(se3=64)), 1)
    assert max(errs.values()) <= 1e-5, (errs, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("args,nv", [
    (GTAArgs(f_dims=FDims(se3=64)), 2),
    (MSN_ARGS, 1),
    (MSN_ARGS, 2),
    (MSN_ARGS, 5),
], ids=["se3_64-2views", "msn_so3_c96-1view", "msn_so3_c96-2views", "msn_so3_c96-5views"])
def test_gta_fused_bwd_error_with_common_component_across_views_and_rotors(rng, cuda_device, args, nv):
    """The same rows where one centre per (b, h) cannot remove the common
    component: each view's transform moves it and the so2 rotors turn it.
    Every output within 1e-4 relative L2 of fp64, ten times the one-view
    bound: the gradients here reach 1-2e-5 (dq, dk) and, at msn_so3's two
    views, 8e-5 (dMq, dMk), where the plain version in fp32 on the card
    stays below 2e-5. That gap is an open fault (ROADMAP queue 3)."""
    errs, plain = _common_component_errors(rng, cuda_device, args, nv)
    assert max(errs.values()) <= 1e-4, (errs, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk,nv", [(640, 640, 5), (192, 640, 5)])
def test_gta_fused_c96_error_against_fp64(rng, cuda_device, tq, tk, nv):
    """Both kernels at C = 96 with msn_so3's f_dims, 5 views of 128 keys
    (self-attention, and 3 x 64 target rays): out, z and every gradient
    within 1e-5 relative L2 of fp64."""
    torch.backends.cuda.matmul.allow_tf32 = False
    reps, _, (q, k, v) = _inputs(rng, MSN_ARGS, cuda_device, tq=tq, tk=tk, nv=nv, heads=MSN_H)
    qB, kB, vB = (_tokens(x).to(cuda_device) for x in (q, k, v))
    g = torch.randn(qB.shape, generator=torch.Generator(device=cuda_device).manual_seed(9), device=cuda_device)
    with torch.no_grad():
        t = tgf.fused_tables(reps, MSN_ARGS, torch.tensor([0.3], device=cuda_device))
        errs, _ = _fp64_errors(qB, kB, vB, t, MSN_H, 96**-0.5, g)
    assert sorted(errs) == ["dk", "dmk", "dmo", "dmq", "dq", "dv", "out", "z"]
    assert max(errs.values()) <= 1e-5, errs


@pytest.mark.cuda
def test_gta_fused_c96_matches_plain_and_is_deterministic(rng, cuda_device):
    """At C = 96 (msn_so3's f_dims, 8 heads, 5 views): the layer entry's
    forward on the card against the same call on the CPU (atol 1e-4), and
    two backward launches on the same inputs bit-identical."""
    reps, cpu_reps, (q, k, v) = _inputs(rng, MSN_ARGS, cuda_device, tq=640, tk=640, nv=5, heads=MSN_H)
    tc = torch.tensor([0.01])
    with torch.no_grad():
        fwd = tgf.gta_fused_fwd.launches
        got = _fused(*(x.to(cuda_device) for x in (q, k, v)), reps, MSN_ARGS, tc.to(cuda_device), 96**-0.5)
        torch.cuda.synchronize()
        assert tgf.gta_fused_fwd.launches == fwd + 1
        want = _fused(q, k, v, cpu_reps, MSN_ARGS, tc, 96**-0.5)
        assert (got.cpu() - want).abs().max().item() <= 1e-4
        qB, kB, vB = (_tokens(x).to(cuda_device) for x in (q, k, v))
        t = tgf.fused_tables(reps, MSN_ARGS, torch.tensor([0.3], device=cuda_device))
        _, res = tgf.gta_fused_fwd(qB, kB, vB, t, MSN_H, 96**-0.5, residuals=True)
        g = torch.randn(qB.shape, generator=torch.Generator(device=cuda_device).manual_seed(2), device=cuda_device)
        first = tgf.gta_fused_bwd(qB, kB, vB, t, MSN_H, 96**-0.5, g, res)
        second = tgf.gta_fused_bwd(qB, kB, vB, t, MSN_H, 96**-0.5, g, res)
    for name, a, b in zip(("dq", "dk", "dv", "dmq", "dmk", "dmo"), first, second):
        assert a is not None, name
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("args", [MSN_ARGS, GTAArgs(f_dims=FDims(triv=96))], ids=["msn_so3", "triv_96"])
@pytest.mark.parametrize("tq", [1, 17, 601])
@pytest.mark.parametrize("tk", [1, 33, 2100])
def test_gta_fused_c96_kernels_match_plain_at_edge_shapes(rng, cuda_device, args, tq, tk):
    """The C = 96 instances at the ragged shapes of the C = 64 edge test,
    one view per side, with every transform (se3, so3, so2) and with none:
    out and z within atol 1e-4, each backward output within
    1e-4 * max(1, max|plain|)."""
    reps, q, k, v, g = _edge_inputs(rng, args, cuda_device, tq, tk, heads=MSN_H)
    with torch.no_grad():
        t = tgf.fused_tables(reps, args, torch.tensor([0.3], device=cuda_device))
        out, res = tgf.gta_fused_fwd(q, k, v, t, MSN_H, 96**-0.5, residuals=True)
        got = tgf.gta_fused_bwd(q, k, v, t, MSN_H, 96**-0.5, g, res)
        torch.cuda.synchronize()
        want_out, want_z = tgf.gta_fused_fwd_plain(q, k, v, t, MSN_H, 96**-0.5, store_z=True)
        want = tgf.gta_fused_bwd_plain(q, k, v, t, MSN_H, 96**-0.5, g, res.z)
    assert (out - want_out).abs().max().item() <= 1e-4
    assert (res.z - want_z).abs().max().item() <= 1e-4
    for name, a, b in zip(("dq", "dk", "dv", "dmq", "dmk", "dmo"), got, want):
        assert (a is None) == (b is None), name
        if b is not None:
            assert (a - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max().item()), name


# ---------------------------------------------------------------------------
# flash_core (csrc/flash_core_fwd.cu, csrc/flash_core_bwd.cu): plain softmax
# attention, token-major [B, T, H*C] operands, through the attention core
# the fused GTA kernels share (csrc/attn_core.cuh)
# ---------------------------------------------------------------------------


def _flash_inputs(device, tq, tk, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((B, t, H * C), generator=gen, device=device) for t in (tq, tk, tk, tq)]


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [1, 601])
@pytest.mark.parametrize("tk", [1, 33, 2100])
def test_flash_core_kernels_match_plain_at_edge_shapes(cuda_device, tq, tk):
    """One query or key, a ragged last tile on both sides (601 rows, 33
    keys) and more keys than the Pallas kernel holds in VMEM (2100): the
    forward within atol 1e-4, its log-sum-exp too, and each backward output
    within 1e-4 * max(1, max|plain|) (fp32; summation orders differ)."""
    q, k, v, g = _flash_inputs(cuda_device, tq, tk)
    with torch.no_grad():
        fwd, bwd = fc.flash_core_fwd.launches, fc.flash_core_bwd.launches
        out, lse = fc.flash_core_fwd(q, k, v, H, SCALE, residuals=True)
        grads = fc.flash_core_bwd(q, k, v, H, SCALE, g, out, lse)
        torch.cuda.synchronize()
        assert (fc.flash_core_fwd.launches - fwd, fc.flash_core_bwd.launches - bwd) == (1, 1)
        want, want_lse = fc.flash_core_fwd_plain(q, k, v, H, SCALE, lse=True)
        want_grads = fc.flash_core_bwd_plain(q, k, v, H, SCALE, g)
    assert (out - want).abs().max().item() <= 1e-4
    assert (lse - want_lse).abs().max().item() <= 1e-4
    for name, a, b in zip(("dq", "dk", "dv"), grads, want_grads):
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max().item()), name


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk", [(600, 600), (2560, 600)])
def test_flash_core_bwd_error_against_fp64(cuda_device, tq, tk):
    """The backward kernel against the plain version in fp64, as relative L2
    errors per output: a query or key dropped from or counted twice in a sum
    would show as ~1e-3; fp32 rounding stays near 1e-6."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g = _flash_inputs(cuda_device, tq, tk, seed=1)
    with torch.no_grad():
        out, lse = fc.flash_core_fwd(q, k, v, H, SCALE, residuals=True)
        got = fc.flash_core_bwd(q, k, v, H, SCALE, g, out, lse)
        ref = fc.flash_core_bwd_plain(*(x.double() for x in (q, k, v)), H, SCALE, g.double())
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert ((a.double() - r).norm() / r.norm()).item() <= 1e-5, name


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk", [(600, 600), (2560, 600)])
def test_flash_core_fwd_error_against_fp64(cuda_device, tq, tk):
    """The forward kernel's out and lse against the plain version in fp64,
    as relative L2 errors: fp32 accuracy (3xTF32) keeps them near 1e-7, a
    single TF32 pass (10-bit operands) would give ~1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, _ = _flash_inputs(cuda_device, tq, tk, seed=4)
    with torch.no_grad():
        out, lse = fc.flash_core_fwd(q, k, v, H, SCALE, residuals=True)
        ref_out, ref_lse = fc.flash_core_fwd_plain(*(x.double() for x in (q, k, v)), H, SCALE, lse=True)
    for name, a, r in (("out", out, ref_out), ("lse", lse, ref_lse)):
        assert ((a.double() - r).norm() / r.norm()).item() <= 1e-5, name


@pytest.mark.cuda
def test_flash_core_bwd_error_against_fp64_with_common_key_component(cuda_device):
    """Keys and values that share a large component, as a layer's tokens do.
    The tensor cores truncate each product's sum by ~1e-6 of its value, so
    about uncentred rows each row of dS no longer sums to zero and dq = dS k
    gains that sum times the common key (3.4e-4 relative L2 here without
    the kernels' centres, 3.1e-5 with centres in the backward alone). The
    forward's output and every gradient within 1e-5 of fp64."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g = _flash_inputs(cuda_device, 2560, 600, seed=6)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    k = k + 8 * torch.randn((B, 1, H * C), generator=gen, device=cuda_device)
    v = v + 8 * torch.randn((B, 1, H * C), generator=gen, device=cuda_device)
    with torch.no_grad():
        out, lse = fc.flash_core_fwd(q, k, v, H, SCALE, residuals=True)
        got = fc.flash_core_bwd(q, k, v, H, SCALE, g, out, lse)
        ref_out = fc.flash_core_fwd_plain(*(x.double() for x in (q, k, v)), H, SCALE)
        ref = fc.flash_core_bwd_plain(*(x.double() for x in (q, k, v)), H, SCALE, g.double())
    for name, a, r in zip(("out", "dq", "dk", "dv"), (out, *got), (ref_out, *ref)):
        assert ((a.double() - r).norm() / r.norm()).item() <= 1e-5, name


@pytest.mark.cuda
def test_flash_core_bwd_is_deterministic(cuda_device):
    """Two backward launches on the same inputs give bit-identical outputs:
    every row is owned by one warp and every sum has a fixed order."""
    q, k, v, g = _flash_inputs(cuda_device, 601, 600, seed=5)
    with torch.no_grad():
        out, lse = fc.flash_core_fwd(q, k, v, H, SCALE, residuals=True)
        first = fc.flash_core_bwd(q, k, v, H, SCALE, g, out, lse)
        second = fc.flash_core_bwd(q, k, v, H, SCALE, g, out, lse)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_flash_core_function_grads_on_card_match_cpu(cuda_device):
    """FlashCore through both kernels on the card, from strided q/k/v views
    (the chunks of a fused projection), against the plain versions on the
    CPU; gradients come back in the views' token-major layout."""
    x = torch.randn((B, 600, 3 * H * C), generator=torch.Generator().manual_seed(2))
    g = torch.randn((B, 600, H * C), generator=torch.Generator().manual_seed(3))
    grads = {}
    for dev in ("cpu", cuda_device):
        leaf = x.to(dev, copy=True).requires_grad_()
        fwd, bwd = fc.flash_core_fwd.launches, fc.flash_core_bwd.launches
        out = fc.flash_core(*leaf.chunk(3, dim=-1), H, SCALE)
        out.backward(g.to(dev))
        launched = (fc.flash_core_fwd.launches - fwd, fc.flash_core_bwd.launches - bwd)
        assert launched == ((0, 0) if dev == "cpu" else (1, 1))
        grads[str(dev)] = (out.detach().cpu(), leaf.grad.cpu())
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max().item())


@pytest.mark.cuda
def test_flash_core_raises_instead_of_falling_back(cuda_device):
    """Head width 32, non-contiguous and fp64 operands raise, and so does a
    launch the card refuses (a grid of more than 65535 batches): nothing
    falls back to the plain version."""
    q, k, v, g = _flash_inputs(cuda_device, 64, 64)
    with torch.no_grad():
        out, lse = fc.flash_core_fwd(q, k, v, H, SCALE, residuals=True)
        fwd, bwd = fc.flash_core_fwd.launches, fc.flash_core_bwd.launches
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 3"):
            fc.flash_core_fwd(q, k, v, 2 * H, SCALE)
        with pytest.raises(ValueError, match="contiguous fp32"):
            fc.flash_core_bwd(q, k, v, H, SCALE, g.transpose(1, 2).contiguous().transpose(1, 2), out, lse)
        with pytest.raises(ValueError, match="contiguous fp32"):
            fc.flash_core_fwd(q.double(), k, v, H, SCALE)
        assert (fc.flash_core_fwd.launches, fc.flash_core_bwd.launches) == (fwd, bwd)
        big = torch.zeros((70000, 1, H * C), device=cuda_device)
        with pytest.raises(RuntimeError, match="flash_core_fwd launch failed"):
            fc.flash_core_fwd(big, big, big, H, SCALE)


@pytest.mark.cuda
def test_failed_build_raises_with_the_compiler_output(cuda_device, tmp_path, monkeypatch):
    (tmp_path / "flash_core_fwd.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda, "_libs", {})
    q = torch.zeros((B, 4, H * C), device=cuda_device)
    with torch.no_grad(), pytest.raises(RuntimeError, match="nvcc failed for flash_core_fwd"):
        fc.flash_core_fwd(q, q, q, H, SCALE)


# ---------------------------------------------------------------------------
# The bf16 instances of all four kernels (bf16 q, k, v and cotangents, fp32
# tables, fp32 accumulation): each output held to fp64 on the same bf16
# inputs, beside the plain version with mxu_dtype=bf16, which rounds every
# product's operands to bf16 as the TPU kernels do. Rule: per output, the
# kernel's relative L2 error is at most 1.5x the emulation's.
# ---------------------------------------------------------------------------

BF = torch.bfloat16


def _rel(a, r):
    """Relative L2 error of a against r; where r is all zero (a single key
    gives dq = dk = 0), the norm of a."""
    den = r.norm().item()
    return ((a.double() - r).norm() / den).item() if den > 0 else a.double().norm().item()


def _bf16_gta_errors(qB, kB, vB, t, heads, scale, g):
    """({output: kernel's relative L2 error against fp64}, {output: the
    bf16 emulation's}) for the fused GTA kernels on bf16 copies of the
    operands (out, z, dq, dk, dv, dmq, dmk, dmo; absent ones left out)."""
    q, k, v, gg = (x.to(BF).contiguous() for x in (qB, kB, vB, g))
    launches = (tgf.gta_fused_fwd.launches_bf16, tgf.gta_fused_bwd.launches_bf16)
    out, res = tgf.gta_fused_fwd(q, k, v, t, heads, scale, residuals=True)
    got = tgf.gta_fused_bwd(q, k, v, t, heads, scale, gg, res)
    torch.cuda.synchronize()
    assert (tgf.gta_fused_fwd.launches_bf16 - launches[0], tgf.gta_fused_bwd.launches_bf16 - launches[1]) == (1, 1)
    assert out.dtype == res.z.dtype == BF and all(x.dtype == BF for x in got[:3])
    assert all(x is None or x.dtype == torch.float32 for x in got[3:])
    emu_out, emu_z = tgf.gta_fused_fwd_plain(q, k, v, t, heads, scale, store_z=True, mxu_dtype=BF)
    emu = tgf.gta_fused_bwd_plain(q, k, v, t, heads, scale, gg, emu_z, mxu_dtype=BF)
    t64 = tgf.FusedTables(*[None if x is None else x.double() for x in tgf._tables(t)], t.nq, t.nk, t.v_transform)
    q64, k64, v64 = q.double(), k.double(), v.double()
    ref_out, ref_z = tgf.gta_fused_fwd_plain(q64, k64, v64, t64, heads, scale, store_z=True)
    ref = tgf.gta_fused_bwd_plain(q64, k64, v64, t64, heads, scale, gg.double(), ref_z)
    names = ("out", "z", "dq", "dk", "dv", "dmq", "dmk", "dmo")

    def rel(values):
        return {n: _rel(a, r) for n, a, r in zip(names, values, (ref_out, ref_z, *ref)) if r is not None}

    return rel((out, res.z, *got)), rel((emu_out, emu_z, *emu))


def _assert_bf16_rule(errs, emu):
    for name, err in errs.items():
        assert err <= 1.5 * emu[name], (name, errs, emu)


@pytest.mark.cuda
@pytest.mark.parametrize("args,tq,tk,nv", [
    (GTAArgs(f_dims=FDims(se3=32, so2=32), so2=8), 600, 600, 2),
    (GTAArgs(f_dims=FDims(se3=32, so2=32), so2=8), 192, 600, 2),
    (GTAArgs(f_dims=FDims(triv=16, se3=16, so2=32), so2=8, v_transform=False), 600, 600, 2),
    (MSN_ARGS, 640, 640, 5),
    (MSN_ARGS, 192, 640, 5),
], ids=["clevr-self", "clevr-cross", "no-v-transform", "msn_so3_c96-self", "msn_so3_c96-cross"])
def test_gta_fused_bf16_error_against_fp64(rng, cuda_device, args, tq, tk, nv):
    """The bf16 instances (C = 64 and C = 96) against fp64 on the same bf16
    inputs: every output within 1.5x the relative L2 error of the bf16
    emulation (the TPU kernel's own rounding)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    heads = H if args.f_dims.total == 64 else MSN_H
    reps, _, (q, k, v) = _inputs(rng, args, cuda_device, tq=tq, tk=tk, nv=nv, heads=heads)
    qB, kB, vB = (_tokens(x).to(cuda_device) for x in (q, k, v))
    g = torch.randn(qB.shape, generator=torch.Generator(device=cuda_device).manual_seed(11), device=cuda_device)
    with torch.no_grad():
        t = tgf.fused_tables(reps, args, torch.tensor([0.3], device=cuda_device))
        errs, emu = _bf16_gta_errors(qB, kB, vB, t, heads, args.f_dims.total**-0.5, g)
    _assert_bf16_rule(errs, emu)


@pytest.mark.cuda
@pytest.mark.parametrize("args,nv", [(GTAArgs(f_dims=FDims(se3=64)), 1), (MSN_ARGS, 2), (MSN_ARGS, 5)],
                         ids=["se3_64-1view", "msn_so3_c96-2views", "msn_so3_c96-5views"])
def test_gta_fused_bf16_error_with_common_component(rng, cuda_device, args, nv):
    """q, k and v rows that share a component of 8x their spread: the bf16
    instances centre kt and vt in fp32 before rounding them to bf16, so each
    output stays within 1.5x the bf16 emulation's error (which rounds the
    uncentred rows)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    heads = H if args.f_dims.total == 64 else MSN_H
    reps, _, (q, k, v) = _inputs(rng, args, cuda_device, tq=600, tk=600, nv=nv, heads=heads)
    qB, kB, vB = (_tokens(x).to(cuda_device) for x in (q, k, v))
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    for x in (qB, kB, vB):
        x += 8 * torch.randn((B, 1, x.shape[-1]), generator=gen, device=cuda_device)
    g = torch.randn(qB.shape, generator=gen, device=cuda_device)
    with torch.no_grad():
        t = tgf.fused_tables(reps, args, torch.tensor([0.3], device=cuda_device))
        errs, emu = _bf16_gta_errors(qB, kB, vB, t, heads, args.f_dims.total**-0.5, g)
    _assert_bf16_rule(errs, emu)


@pytest.mark.cuda
@pytest.mark.parametrize("args,tq,tk", [
    (GTAArgs(f_dims=FDims(se3=32, so2=32), so2=8), 192, 640),
    (MSN_ARGS, 192, 640),
    (GTAArgs(f_dims=FDims(se3=32, so2=32), so2=8), 129, 645),
    (MSN_ARGS, 129, 645),
], ids=["c64", "c96", "c64-ragged", "c96-ragged"])
def test_gta_fused_bf16_bwd_is_deterministic(rng, cuda_device, args, tq, tk):
    """Two bf16 backward launches on the same inputs give bit-identical
    outputs (the query pass and the joint key pass sum in a fixed order;
    ragged: a part tile on either side)."""
    heads = H if args.f_dims.total == 64 else MSN_H
    reps, _, (q, k, v) = _inputs(rng, args, cuda_device, tq=tq, tk=tk, nv=5, heads=heads)
    qB, kB, vB = (_tokens(x).to(cuda_device).to(BF) for x in (q, k, v))
    with torch.no_grad():
        t = tgf.fused_tables(reps, args, torch.tensor([0.3], device=cuda_device))
        _, res = tgf.gta_fused_fwd(qB, kB, vB, t, heads, args.f_dims.total**-0.5, residuals=True)
        g = torch.randn(qB.shape, generator=torch.Generator(device=cuda_device).manual_seed(2), device=cuda_device).to(BF)
        first = tgf.gta_fused_bwd(qB, kB, vB, t, heads, args.f_dims.total**-0.5, g, res)
        second = tgf.gta_fused_bwd(qB, kB, vB, t, heads, args.f_dims.total**-0.5, g, res)
    for name, a, b in zip(("dq", "dk", "dv", "dmq", "dmk", "dmo"), first, second):
        assert a is not None, name
        assert torch.equal(a, b), name


# dit_gta's attention (runs/imagenet/DiT/dit_gta): 6 heads of 64 (triv 32,
# so2 32 with 8 frequencies), self-attention over one view of 16 x 16 patch
# tokens, rotor tables only (no per-view matrix), as models/dit.py builds them
DIT_ARGS = GTAArgs(f_dims=FDims(triv=32, so2=32), so2=8)


def _dit_reps(device, batch):
    from gta_tpu_torch.models.dit import DiTConfig, grid_reps

    return grid_reps(DiTConfig(attn=AttnConfig(method="gta", gta=DIT_ARGS)), batch, device)


@pytest.mark.cuda
@pytest.mark.parametrize("common", [0.0, 8.0], ids=["dit_gta", "dit_gta-common-component"])
def test_gta_fused_bf16_rotor_only_one_view_error_against_fp64(cuda_device, common):
    """The bf16 instances at dit_gta's tables (rotors only: mq, mk, mo
    absent; one view of 256 tokens; a trivial span beside the rotors),
    against fp64 on the same bf16 inputs: every output within 1.5x the bf16
    emulation's relative L2 error, and no matrix cotangent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    qB, kB, vB, g = (torch.randn((B, 256, H * C), generator=gen, device=cuda_device) for _ in range(4))
    for x in (qB, kB, vB):
        x += common * torch.randn((B, 1, H * C), generator=gen, device=cuda_device)
    with torch.no_grad():
        t = tgf.fused_tables(_dit_reps(cuda_device, B), DIT_ARGS, None)
        assert t.mq is None and t.mk is None and t.mo is None and (t.nq, t.nk) == (1, 1)
        errs, emu = _bf16_gta_errors(qB, kB, vB, t, H, SCALE, g)
    assert sorted(errs) == ["dk", "dq", "dv", "out", "z"]
    _assert_bf16_rule(errs, emu)


@pytest.mark.cuda
def test_dit_attention_launches_its_kernels(cuda_device):
    """models/dit.GTASelfAttention on bf16 CUDA rows: dit_gta's layer
    launches the bf16 fused GTA kernels once forward and once backward, the
    stock layer the bf16 flash_core kernels, each matching its plain
    version on the CPU within 1.5x the bf16 emulation's error from fp32."""
    from gta_tpu_torch.models.dit import GTASelfAttention
    from gta_tpu_torch.models.layers import set_compute_dtype

    for attn, fwd, bwd in ((AttnConfig(method="gta", gta=DIT_ARGS), tgf.gta_fused_fwd, tgf.gta_fused_bwd),
                           (AttnConfig(method=""), fc.flash_core_fwd, fc.flash_core_bwd)):
        torch.manual_seed(0)
        layer = set_compute_dtype(GTASelfAttention(H * C, H, attn), BF).to(cuda_device)
        x = torch.randn((B, 256, H * C), device=cuda_device).to(BF).requires_grad_()
        reps = _dit_reps(cuda_device, B) if attn.is_gta else None
        before = (fwd.launches_bf16, bwd.launches_bf16)
        out = layer(x, reps)
        out.float().square().sum().backward()
        torch.cuda.synchronize()
        assert (fwd.launches_bf16 - before[0], bwd.launches_bf16 - before[1]) == (1, 1)
        cpu = set_compute_dtype(GTASelfAttention(H * C, H, attn), torch.float32)
        cpu.load_state_dict({k: v.cpu() for k, v in layer.state_dict().items()})
        with torch.no_grad():
            want = cpu(x.detach().float().cpu(), _dit_reps("cpu", B) if attn.is_gta else None)
        err = (out.detach().float().cpu() - want).norm() / want.norm()
        assert torch.isfinite(out).all() and err < 2e-2, err.item()


# an output rounded to bf16 alone is up to 2^-9 off per element: the floor of
# the edge shapes' rule, where the emulation can be exact (one key)
BF16_ULP = 2.0**-8


BF16_EDGE_BRANCHES = [
    (dict(se3=32, so2=32), 8, True, H),
    (dict(triv=64), 0, True, H),
    (dict(se3=48, so3=24, so2=24), 6, True, MSN_H),
    (dict(se3=32, so2=32), 8, False, H),
    (dict(triv=96), 0, True, MSN_H),
]
BF16_EDGE_IDS = ["c64-every-transform", "c64-none", "c96-msn_so3", "c64-raw-v", "c96-none"]


def _check_bf16_edge(rng, device, fd, so2, vt, heads, tq, tk):
    """Every output of the bf16 instances finite and within max(1.5x the
    bf16 emulation's relative L2 error against fp64, 2^-8)."""
    args = GTAArgs(f_dims=FDims(**fd), so2=so2, so3=2 if "so3" in fd else 0, v_transform=vt)
    reps, q, k, v, g = _edge_inputs(rng, args, device, tq, tk, heads=heads)
    with torch.no_grad():
        t = tgf.fused_tables(reps, args, torch.tensor([0.3], device=device))
        errs, emu = _bf16_gta_errors(q, k, v, t, heads, args.f_dims.total**-0.5, g)
    for name, err in errs.items():
        assert err <= max(1.5 * emu[name], BF16_ULP), (name, errs, emu)


@pytest.mark.cuda
@pytest.mark.parametrize("fd,so2,vt,heads", BF16_EDGE_BRANCHES, ids=BF16_EDGE_IDS)
@pytest.mark.parametrize("tq", [1, 17, 601])
@pytest.mark.parametrize("tk", [1, 33, 2100])
def test_gta_fused_bf16_kernels_at_edge_shapes(rng, cuda_device, fd, so2, vt, heads, tq, tk):
    """The bf16 instances at the ragged shapes of the fp32 edge test, with
    every transform, none (raw token-major q, k, v: the 4-D tensor maps),
    and a raw value side beside transformed keys (`c64-raw-v`)."""
    _check_bf16_edge(rng, cuda_device, fd, so2, vt, heads, tq, tk)


@pytest.mark.cuda
@pytest.mark.parametrize("fd,so2,vt,heads", BF16_EDGE_BRANCHES, ids=BF16_EDGE_IDS)
@pytest.mark.parametrize("tq", [63, 64, 65, 127, 129])
@pytest.mark.parametrize("tk", [63, 64, 65, 127, 129])
def test_gta_fused_bf16_kernels_at_tile_boundaries(rng, cuda_device, fd, so2, vt, heads, tq, tk):
    """The bf16 instances one row short of, at and past the 64-row tiles
    and the 128-row blocks of csrc/attn_sm90.cuh on either side."""
    _check_bf16_edge(rng, cuda_device, fd, so2, vt, heads, tq, tk)


def _bf16_flash_errors(q, k, v, g):
    """({output: relative L2 error against fp64}, {output: the bf16
    emulation's}) for both flash_core kernels on bf16 copies of the
    operands (out, dq, dk, dv)."""
    q, k, v, g = (x.to(BF).contiguous() for x in (q, k, v, g))
    launches = (fc.flash_core_fwd.launches_bf16, fc.flash_core_bwd.launches_bf16)
    out, lse = fc.flash_core_fwd(q, k, v, H, SCALE, residuals=True)
    got = fc.flash_core_bwd(q, k, v, H, SCALE, g, out, lse)
    torch.cuda.synchronize()
    assert (fc.flash_core_fwd.launches_bf16 - launches[0], fc.flash_core_bwd.launches_bf16 - launches[1]) == (1, 1)
    assert all(x.dtype == BF for x in (out, *got))
    emu = (fc.flash_core_fwd_plain(q, k, v, H, SCALE, mxu_dtype=BF), *fc.flash_core_bwd_plain(q, k, v, H, SCALE, g, mxu_dtype=BF))
    q64, k64, v64 = q.double(), k.double(), v.double()
    ref = (fc.flash_core_fwd_plain(q64, k64, v64, H, SCALE), *fc.flash_core_bwd_plain(q64, k64, v64, H, SCALE, g.double()))
    names = ("out", "dq", "dk", "dv")
    return ({n: _rel(a, r) for n, a, r in zip(names, (out, *got), ref)},
            {n: _rel(a, r) for n, a, r in zip(names, emu, ref)})


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk,common", [(600, 600, 0.0), (2560, 600, 0.0), (2560, 600, 8.0), (256, 256, 0.0),
                                          (256, 256, 8.0)],
                         ids=["self", "cross", "cross-common-component", "dit-256", "dit-256-common-component"])
def test_flash_core_bf16_error_against_fp64(cuda_device, tq, tk, common):
    """The bf16 instances against fp64 on the same bf16 inputs, also with
    keys and values that share a component of 8x their spread: every
    output within 1.5x the relative L2 error of the bf16 emulation."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g = _flash_inputs(cuda_device, tq, tk, seed=12)
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    k = k + common * torch.randn((B, 1, H * C), generator=gen, device=cuda_device)
    v = v + common * torch.randn((B, 1, H * C), generator=gen, device=cuda_device)
    with torch.no_grad():
        errs, emu = _bf16_flash_errors(q, k, v, g)
    _assert_bf16_rule(errs, emu)


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [1, 601])
@pytest.mark.parametrize("tk", [1, 33, 2100])
def test_flash_core_bf16_kernels_at_edge_shapes(cuda_device, tq, tk):
    """The bf16 instances at the fp32 edge shapes: every output within
    max(1.5x the bf16 emulation's relative L2 error against fp64, 2^-8)."""
    q, k, v, g = _flash_inputs(cuda_device, tq, tk, seed=14)
    with torch.no_grad():
        errs, emu = _bf16_flash_errors(q, k, v, g)
    for name, err in errs.items():
        assert err <= max(1.5 * emu[name], BF16_ULP), (name, errs, emu)


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [63, 64, 65, 127, 128, 129, 255, 257])
@pytest.mark.parametrize("tk", [63, 64, 65, 127, 128, 129, 255, 257])
def test_flash_core_bf16_kernels_at_tile_boundaries(cuda_device, tq, tk):
    """The bf16 instances one row short of, at and past the 64- and 128-row
    tiles and the 128-row blocks of csrc/attn_sm90.cuh on either side (TMA
    fills rows past the end with zeros per head; keys past Tk score -inf,
    queries past Tq store nothing): every output within max(1.5x the bf16
    emulation's relative L2 error against fp64, 2^-8)."""
    q, k, v, g = _flash_inputs(cuda_device, tq, tk, seed=16)
    with torch.no_grad():
        errs, emu = _bf16_flash_errors(q, k, v, g)
    for name, err in errs.items():
        assert err <= max(1.5 * emu[name], BF16_ULP), (name, errs, emu)


@pytest.mark.cuda
def test_flash_core_bf16_bwd_is_deterministic(cuda_device):
    """Two bf16 backward launches on the same inputs give bit-identical
    outputs."""
    q, k, v, g = (x.to(BF) for x in _flash_inputs(cuda_device, 601, 600, seed=15))
    with torch.no_grad():
        out, lse = fc.flash_core_fwd(q, k, v, H, SCALE, residuals=True)
        first = fc.flash_core_bwd(q, k, v, H, SCALE, g, out, lse)
        second = fc.flash_core_bwd(q, k, v, H, SCALE, g, out, lse)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_uncovered_dtypes_raise(rng, cuda_device):
    """fp16 operands (no instance) raise NotImplementedError naming their
    ROADMAP item on both kernels; bf16 operands beside fp32 ones raise
    ValueError; nothing launches."""
    q, k, v, g = (x.half() for x in _flash_inputs(cuda_device, 64, 64))
    args = GTAArgs(f_dims=FDims(se3=32, so2=32), so2=8)
    reps, _, (qg, kg, vg) = _inputs(rng, args, cuda_device)
    qB, kB, vB = (_tokens(x).to(cuda_device) for x in (qg, kg, vg))
    counts = lambda: (fc.flash_core_fwd.launches, fc.flash_core_fwd.launches_bf16,  # noqa: E731
                      tgf.gta_fused_fwd.launches, tgf.gta_fused_fwd.launches_bf16)
    before = counts()
    with torch.no_grad():
        t = tgf.fused_tables(reps, args, torch.tensor([0.3], device=cuda_device))
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 3e"):
            fc.flash_core_fwd(q, k, v, H, SCALE)
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 3e"):
            tgf.gta_fused_fwd(qB.half(), kB.half(), vB.half(), t, H, SCALE)
        with pytest.raises(ValueError, match="contiguous fp32"):
            tgf.gta_fused_fwd(qB.to(BF), kB, vB, t, H, SCALE)
        with pytest.raises(ValueError, match="contiguous fp32"):
            fc.flash_core_fwd(q.to(BF), k.float(), v.float(), H, SCALE)
    assert counts() == before


# flash_core at head width 96 (msn gta_t2: 8 heads of 96 after the sliced
# GTA transforms): fp32 on attn_core.cuh, bf16 on attn_sm90.cuh with 64-key
# tiles
H96, C96 = 4, 96
SCALE96 = C96**-0.5


def _flash96(device, tq, tk, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((B, t, H96 * C96), generator=gen, device=device) for t in (tq, tk, tk, tq)]


def _flash96_run(q, k, v, g):
    """Both kernels' outputs (out, lse, dq, dk, dv) on q, k, v, g, one
    launch each."""
    bf16 = q.dtype == BF
    count = lambda: (fc.flash_core_fwd.launches_bf16, fc.flash_core_bwd.launches_bf16) if bf16 else (  # noqa: E731
        fc.flash_core_fwd.launches, fc.flash_core_bwd.launches)
    before = count()
    out, lse = fc.flash_core_fwd(q, k, v, H96, SCALE96, residuals=True)
    grads = fc.flash_core_bwd(q, k, v, H96, SCALE96, g, out, lse)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(count(), before)) == (1, 1)
    return out, lse, grads


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [1, 601])
@pytest.mark.parametrize("tk", [1, 33, 2100])
def test_flash_core_c96_kernels_match_plain_at_edge_shapes(cuda_device, tq, tk):
    """The fp32 instances at head width 96 on the C = 64 edge shapes: the
    forward and its log-sum-exp within atol 1e-4, each backward output
    within 1e-4 * max(1, max|plain|)."""
    q, k, v, g = _flash96(cuda_device, tq, tk, seed=20)
    with torch.no_grad():
        out, lse, grads = _flash96_run(q, k, v, g)
        want, want_lse = fc.flash_core_fwd_plain(q, k, v, H96, SCALE96, lse=True)
        want_grads = fc.flash_core_bwd_plain(q, k, v, H96, SCALE96, g)
    assert (out - want).abs().max().item() <= 1e-4
    assert (lse - want_lse).abs().max().item() <= 1e-4
    for name, a, b in zip(("dq", "dk", "dv"), grads, want_grads):
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max().item()), name


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk", [(1280, 1280), (2560, 1280)], ids=["encoder", "decoder"])
def test_flash_core_c96_error_against_fp64(cuda_device, tq, tk):
    """The fp32 instances at head width 96 at msn's encoder and decoder
    shapes against fp64: out, lse, dq, dk, dv within 1e-5 relative L2."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g = _flash96(cuda_device, tq, tk, seed=21)
    with torch.no_grad():
        out, lse, grads = _flash96_run(q, k, v, g)
        q64, k64, v64, g64 = (x.double() for x in (q, k, v, g))
        ref_out, ref_lse = fc.flash_core_fwd_plain(q64, k64, v64, H96, SCALE96, lse=True)
        ref = fc.flash_core_bwd_plain(q64, k64, v64, H96, SCALE96, g64)
    for name, a, r in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, *grads), (ref_out, ref_lse, *ref)):
        assert _rel(a, r) <= 1e-5, name


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk,common", [(1280, 1280, 0.0), (2560, 1280, 0.0), (2560, 1280, 8.0)],
                         ids=["self", "cross", "cross-common-component"])
def test_flash_core_c96_bf16_error_against_fp64(cuda_device, tq, tk, common):
    """The bf16 instances at head width 96 against fp64 on the same bf16
    inputs, also with keys and values that share a component of 8x their
    spread: out, dq, dk, dv within 1.5x the relative L2 error of the bf16
    emulation (the TPU kernel's rounding)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g = _flash96(cuda_device, tq, tk, seed=22)
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    k = k + common * torch.randn((B, 1, H96 * C96), generator=gen, device=cuda_device)
    v = v + common * torch.randn((B, 1, H96 * C96), generator=gen, device=cuda_device)
    q, k, v, g = (x.to(BF) for x in (q, k, v, g))
    with torch.no_grad():
        out, _, grads = _flash96_run(q, k, v, g)
        assert all(x.dtype == BF for x in (out, *grads))
        emu = (fc.flash_core_fwd_plain(q, k, v, H96, SCALE96, mxu_dtype=BF),
               *fc.flash_core_bwd_plain(q, k, v, H96, SCALE96, g, mxu_dtype=BF))
        q64, k64, v64, g64 = (x.double() for x in (q, k, v, g))
        ref = (fc.flash_core_fwd_plain(q64, k64, v64, H96, SCALE96),
               *fc.flash_core_bwd_plain(q64, k64, v64, H96, SCALE96, g64))
    names = ("out", "dq", "dk", "dv")
    _assert_bf16_rule({n: _rel(a, r) for n, a, r in zip(names, (out, *grads), ref)},
                      {n: _rel(a, r) for n, a, r in zip(names, emu, ref)})


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [1, 63, 64, 65, 127, 129, 601])
@pytest.mark.parametrize("tk", [1, 33, 63, 64, 65, 127, 129, 2100])
def test_flash_core_c96_bf16_kernels_at_edge_shapes(cuda_device, tq, tk):
    """The bf16 instances at head width 96 one row short of, at and past
    their 64-row tiles and 128-row blocks, and at the edge shapes: every
    output within max(1.5x the bf16 emulation's relative L2 error against
    fp64, 2^-8)."""
    q, k, v, g = (x.to(BF) for x in _flash96(cuda_device, tq, tk, seed=24))
    with torch.no_grad():
        out, _, grads = _flash96_run(q, k, v, g)
        emu = (fc.flash_core_fwd_plain(q, k, v, H96, SCALE96, mxu_dtype=BF),
               *fc.flash_core_bwd_plain(q, k, v, H96, SCALE96, g, mxu_dtype=BF))
        q64, k64, v64, g64 = (x.double() for x in (q, k, v, g))
        ref = (fc.flash_core_fwd_plain(q64, k64, v64, H96, SCALE96),
               *fc.flash_core_bwd_plain(q64, k64, v64, H96, SCALE96, g64))
    for name, a, e, r in zip(("out", "dq", "dk", "dv"), (out, *grads), emu, ref):
        assert _rel(a, r) <= max(1.5 * _rel(e, r), BF16_ULP), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["fp32", "bf16"])
def test_flash_core_c96_bwd_is_deterministic(cuda_device, dtype):
    """Two backward launches at head width 96 on the same inputs give
    bit-identical outputs."""
    q, k, v, g = (x.to(dtype) for x in _flash96(cuda_device, 601, 1280, seed=25))
    with torch.no_grad():
        out, lse = fc.flash_core_fwd(q, k, v, H96, SCALE96, residuals=True)
        first = fc.flash_core_bwd(q, k, v, H96, SCALE96, g, out, lse)
        second = fc.flash_core_bwd(q, k, v, H96, SCALE96, g, out, lse)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


# the bf16 instances writing fp32 (GTA's sliced path under bf16: the TPU
# kernel takes the transforms' fp32 rows, rounds its product operands to
# bf16 and writes out, dq, dk, dv in fp32, gta_tpu/ops/flash_core.py:145,
# :168-174)
WIDTHS = {64: (H, C), 96: (H96, C96)}


def _wide_inputs(device, width, tq, tk, seed):
    heads, c = WIDTHS[width]
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((B, t, heads * c), generator=gen, device=device).to(BF) for t in (tq, tk, tk, tq)]


def _wide_errors(q, k, v, g, heads, scale):
    """({output: the fp32-writing bf16 instance's relative L2 error against
    fp64}, {output: the bf16 emulation's, fp32 out}); one launch of each
    kernel, every output fp32."""
    f32 = torch.float32
    before = (fc.flash_core_fwd.launches_bf16, fc.flash_core_bwd.launches_bf16)
    out, lse = fc.flash_core_fwd(q, k, v, heads, scale, residuals=True, out_dtype=f32)
    grads = fc.flash_core_bwd(q, k, v, heads, scale, g, out, lse, out_dtype=f32)
    torch.cuda.synchronize()
    assert (fc.flash_core_fwd.launches_bf16 - before[0], fc.flash_core_bwd.launches_bf16 - before[1]) == (1, 1)
    assert all(x.dtype == f32 for x in (out, *grads))
    emu = (fc.flash_core_fwd_plain(q, k, v, heads, scale, mxu_dtype=BF, out_dtype=f32),
           *fc.flash_core_bwd_plain(q, k, v, heads, scale, g, mxu_dtype=BF, out_dtype=f32))
    q64, k64, v64, g64 = (x.double() for x in (q, k, v, g))
    ref = (fc.flash_core_fwd_plain(q64, k64, v64, heads, scale), *fc.flash_core_bwd_plain(q64, k64, v64, heads, scale, g64))
    names = ("out", "dq", "dk", "dv")
    return ({n: _rel(a, r) for n, a, r in zip(names, (out, *grads), ref)},
            {n: _rel(a, r) for n, a, r in zip(names, emu, ref)})


@pytest.mark.cuda
@pytest.mark.parametrize("width,tq,tk", [(64, 2560, 600), (96, 1280, 1280), (96, 2560, 1280)],
                         ids=["c64-cross", "c96-self", "c96-cross"])
def test_flash_core_bf16_fp32_out_error_against_fp64(cuda_device, width, tq, tk):
    """The bf16 instances writing fp32, at CLEVR-TR's decoder and msn's
    encoder and decoder shapes, against fp64 on the same bf16 inputs: out,
    dq, dk, dv within 1.5x the relative L2 error of the bf16 emulation with
    fp32 outputs; and rounded to bf16, bit for bit the bf16 outputs of the
    same instance (one accumulator, two stores)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    heads, c = WIDTHS[width]
    q, k, v, g = _wide_inputs(cuda_device, width, tq, tk, seed=30)
    with torch.no_grad():
        errs, emu = _wide_errors(q, k, v, g, heads, c**-0.5)
        wide, lse = fc.flash_core_fwd(q, k, v, heads, c**-0.5, residuals=True, out_dtype=torch.float32)
        narrow, _ = fc.flash_core_fwd(q, k, v, heads, c**-0.5, residuals=True)
        wide_grads = fc.flash_core_bwd(q, k, v, heads, c**-0.5, g, wide, lse, out_dtype=torch.float32)
        narrow_grads = fc.flash_core_bwd(q, k, v, heads, c**-0.5, g, narrow, lse)
    _assert_bf16_rule(errs, emu)
    for name, a, b in zip(("out", "dq", "dk", "dv"), (wide, *wide_grads), (narrow, *narrow_grads)):
        assert torch.equal(a.to(BF), b), name


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 96])
@pytest.mark.parametrize("tq", [1, 65, 601])
@pytest.mark.parametrize("tk", [1, 33, 129, 2100])
def test_flash_core_bf16_fp32_out_at_edge_shapes(cuda_device, width, tq, tk):
    """The bf16 instances writing fp32 at edge and tile-boundary shapes:
    every output within max(1.5x the bf16 emulation's relative L2 error
    against fp64, 2^-8)."""
    heads, c = WIDTHS[width]
    q, k, v, g = _wide_inputs(cuda_device, width, tq, tk, seed=31)
    with torch.no_grad():
        errs, emu = _wide_errors(q, k, v, g, heads, c**-0.5)
    for name, err in errs.items():
        assert err <= max(1.5 * emu[name], BF16_ULP), (name, errs, emu)


@pytest.mark.cuda
def test_flash_core_bf16_products_on_fp32_rows_through_autograd(cuda_device):
    """flash_core(..., mxu_dtype=bf16) on fp32 operands that require grad
    (GTA's sliced path under bf16): one launch of each bf16 instance, the
    output and the gradients fp32 and equal to the fp32-writing instance's
    on the operands and the cotangent rounded to bf16."""
    q, k, v, g = (x.float() for x in _wide_inputs(cuda_device, 96, 601, 1280, seed=32))
    g = g + 1e-3 * torch.randn_like(g)  # a cotangent that is not on the bf16 grid
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (fc.flash_core_fwd.launches_bf16, fc.flash_core_bwd.launches_bf16, fc.flash_core_fwd.launches)
    out = fc.flash_core(*leaves, H96, SCALE96, mxu_dtype=BF)
    out.backward(g)
    torch.cuda.synchronize()
    assert (fc.flash_core_fwd.launches_bf16 - before[0], fc.flash_core_bwd.launches_bf16 - before[1],
            fc.flash_core_fwd.launches - before[2]) == (1, 1, 0)
    assert out.dtype == torch.float32 and all(x.grad.dtype == torch.float32 for x in leaves)
    with torch.no_grad():
        rq, rk, rv = (x.to(BF) for x in (q, k, v))
        want, lse = fc.flash_core_fwd(rq, rk, rv, H96, SCALE96, residuals=True, out_dtype=torch.float32)
        want_grads = fc.flash_core_bwd(rq, rk, rv, H96, SCALE96, g.to(BF), want, lse, out_dtype=torch.float32)
    assert torch.equal(out.detach(), want)
    for name, x, w in zip(("dq", "dk", "dv"), leaves, want_grads):
        assert torch.equal(x.grad, w), name


def _flagship(**training):
    """The flagship at full width on synthetic scenes, dropout 0."""
    import dataclasses
    import os

    from gta_tpu_torch.config import load_config

    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "runs", "clevrtr", "GTA", "gta", "config.yaml"))
    m = cfg.model
    model = dataclasses.replace(m, encoder=dataclasses.replace(m.encoder, dropout=0.0),
                                decoder=dataclasses.replace(m.decoder, dropout=0.0))
    return dataclasses.replace(cfg, model=model, data=dataclasses.replace(cfg.data, dataset="synthetic"),
                               training=dataclasses.replace(cfg.training, **training))


@pytest.mark.cuda
@pytest.mark.parametrize("batch_size", [32])
def test_accumulated_flagship_gradient_matches_the_full_batch(cuda_device, batch_size):
    """The full-width flagship's gradient at grad_accum 2 (two strided
    microbatches through the fused GTA kernels) against the unaccumulated
    one on the same weights and its batch of 32: relative L2 <= 1e-5 over
    the whole gradient, and twice the kernels' launches. At batch_size 4
    the conv stem's weight gradients (cuDNN's fp32 sums over 2 against 4
    items) move 7.7e-5 - 9.6e-5 of their norms and the whole gradient
    6.6e-5, inside the ~5e-4 from fp64 that chip_smoke.grads_phase records
    for a conv stem's weight gradient (ROADMAP queue 3): the message names
    the worst tensors."""
    from gta_tpu_torch.data.synthetic import SyntheticScenes, collate
    from gta_tpu_torch.train.trainer import Trainer

    cfg = _flagship()
    ds = SyntheticScenes(cfg.data, "train")
    batch = collate([ds[i] for i in range(batch_size)])
    grads, launches = [], []
    for accum in (1, 2):
        trainer = Trainer(_flagship(grad_accum=accum), device="cuda")
        tgf.gta_fused_fwd.launches = tgf.gta_fused_bwd.launches = 0
        _, _, g = trainer.loss_and_grads(batch)
        grads.append({n: p.grad.double().cpu() for n, p in trainer.model.named_parameters()})
        launches.append((tgf.gta_fused_fwd.launches, tgf.gta_fused_bwd.launches))
        del trainer, g
    layers = cfg.model.encoder.num_att_blocks + cfg.model.decoder.num_att_blocks
    assert launches == [(layers, layers), (2 * layers, 2 * layers)]
    total = torch.sqrt(sum((g ** 2).sum() for g in grads[0].values())).item()
    diff = {n: torch.linalg.vector_norm(grads[1][n] - g).item() for n, g in grads[0].items()}
    err = np.sqrt(sum(d ** 2 for d in diff.values())) / total
    worst = sorted(diff, key=diff.get, reverse=True)[:4]
    assert err <= 1e-5, (err, [(n, diff[n] / total, diff[n] / max(torch.linalg.vector_norm(grads[0][n]).item(),
                                                                   1e-30)) for n in worst])


@pytest.mark.cuda
def test_world_size_one_nccl_average_is_the_local_gradient(cuda_device):
    """A one-rank NCCL group (tcp://localhost): parallel.dist.average_
    all-reduces the gradients and scalars through NCCL and leaves them as
    they are, the flag above 0."""
    import socket

    import torch.distributed as dist

    from gta_tpu_torch.parallel import dist as pdist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        assert pdist.world() == 1 and dist.get_backend() == "nccl"
        g = [torch.randn(37, 5, device=cuda_device), torch.randn(11, device=cuda_device)]
        want = [x.clone() for x in g]
        loss, flag = pdist.average_(g, [torch.tensor(0.5, device=cuda_device), torch.tensor(1.0, device=cuda_device)])
        assert all(torch.equal(a, b) for a, b in zip(g, want)) and loss.item() == 0.5 and flag.item() > 0
    finally:
        dist.destroy_process_group()
