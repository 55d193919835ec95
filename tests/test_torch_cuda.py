"""The port's CUDA kernels on the card, against their plain PyTorch versions.

A CUDA kernel has no CPU mode, so every test here is marked `cuda` and skips
without a card. The file imports only torch, numpy and the port, so it runs
on a GPU machine that has no flax:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from gta_tpu_torch.config import FDims, GTAArgs
from gta_tpu_torch.ops import gta_fused as tgf
from gta_tpu_torch.ops.reps import encoder_reps

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


def _fused(q, k, v, reps, args, tc):
    """The layer's token-major entry, called with [B, H, T, C] operands."""
    def tokens(x):
        return x.transpose(1, 2).reshape(B, x.shape[2], -1)

    out = tgf.fused_gta_attention_tokens(tokens(q), tokens(k), tokens(v), H, reps, args, tc, SCALE)
    return out.reshape(B, q.shape[2], H, -1).transpose(1, 2)


def _inputs(rng, args, device, tq=600, tk=600, nv=2):
    coord = torch.from_numpy(rng.rand(B, nv, tk // nv, 2).astype(np.float32))
    tf = torch.from_numpy(np.stack([random_se3(rng, nv) for _ in range(B)]))
    reps = encoder_reps(args, coord.to(device), tf.to(device))
    cpu_reps = encoder_reps(args, coord, tf)
    qkv = [torch.from_numpy(rng.randn(B, H, t, C).astype(np.float32)) for t in (tq, tk, tk)]
    return reps, cpu_reps, qkv


@pytest.mark.cuda
@pytest.mark.parametrize("fd,so2,vt", [
    (dict(se3=32, so2=32), 8, True),
    (dict(so2=64), 16, True),
    (dict(se3=64), 0, True),
    (dict(triv=16, se3=16, so2=32), 8, False),
])
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
def test_gta_fused_fwd_raises_instead_of_falling_back(rng, cuda_device):
    args = GTAArgs(f_dims=FDims(se3=32, so2=32), so2=8)
    reps, _, (q, k, v) = _inputs(rng, args, cuda_device)
    q, k, v = (x.to(cuda_device) for x in (q, k, v))
    tc = torch.tensor([0.01], device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="_bwd_kernel"):
        _fused(q, k, v, reps, args, tc)
    narrow = GTAArgs(f_dims=FDims(se3=16, so2=16), so2=4)
    reps32, _, (q32, k32, v32) = _inputs(rng, narrow, cuda_device)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="head dim"):
        _fused(q32[..., :32].to(cuda_device), k32[..., :32].to(cuda_device), v32[..., :32].to(cuda_device),
               reps32, narrow, None)
