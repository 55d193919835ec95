"""The port's flash_core (gta_tpu_torch/ops/flash_core.py) against the JAX
package's Pallas flash_core on the CPU.

The same numpy inputs go through:
  * the JAX `flash_core(q, k, v, scale, interpret=True)` (`_fwd_kernel`) and
    its `jax.vjp` (`_bwd_kernel` through the custom VJP), in interpret mode
    as the JAX package's own tests run it on the CPU;
  * the port's `FlashCore` on CPU tensors, whose forward and backward are
    the kernels' plain versions (`flash_core_fwd_plain`,
    `flash_core_bwd_plain`).
Shapes at B=2, H=2, C=64 cover self-attention, Tq > Tk, Tk > Tq and single
rows, none of them a multiple of the Pallas block. Forward within atol
1e-5, dq/dk/dv within atol 1e-4 (fp32; the orders of summation differ).

The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gta_tpu.ops.flash_core import flash_core as j_flash_core
from gta_tpu_torch.ops import flash_core as fc
from gta_tpu_torch.ops.flash import flash_attention

B, H, C = 2, 2, 64
SCALE = C**-0.5
FWD_ATOL, GRAD_ATOL = 1e-5, 1e-4


def _tokens(x):
    """[B, H, T, C] numpy -> token-major [B, T, H*C] torch."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(x.shape[0], x.shape[2], -1)))


def _heads(x):
    return x.detach().reshape(x.shape[0], x.shape[1], H, -1).transpose(1, 2).numpy()


def _inputs(rng, tq, tk):
    return [rng.randn(B, H, t, C).astype(np.float32) for t in (tq, tk, tk, tq)]


@pytest.mark.parametrize("tq,tk", [(600, 600), (600, 300), (48, 600), (1, 33)])
def test_flash_core_matches_jax_interpret_kernel(rng, tq, tk):
    q, k, v, g = _inputs(rng, tq, tk)
    j_out, vjp = jax.vjp(lambda q, k, v: j_flash_core(q, k, v, SCALE, True), *(jnp.asarray(x) for x in (q, k, v)))
    j_grads = vjp(jnp.asarray(g))

    leaves = [_tokens(x).requires_grad_() for x in (q, k, v)]
    fwd, bwd = fc.flash_core_fwd.launches, fc.flash_core_bwd.launches
    out = fc.flash_core(*leaves, H, SCALE)
    assert "FlashCore" in type(out.grad_fn).__name__
    out.backward(_tokens(g))
    assert (fc.flash_core_fwd.launches, fc.flash_core_bwd.launches) == (fwd, bwd), "CPU tensors take the plain versions"

    np.testing.assert_allclose(_heads(out), np.asarray(j_out), atol=FWD_ATOL)
    for x, want, name in zip(leaves, j_grads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(_heads(x.grad), np.asarray(want), atol=GRAD_ATOL, err_msg=name)


def test_plain_versions_match_autograd_and_logsumexp(rng):
    """flash_core_bwd_plain (the Pallas formula, delta = rowsum(p * dp))
    equals torch.autograd through the plain forward, and the forward's lse
    residual is each row's log-sum-exp."""
    q, k, v, g = (_tokens(x) for x in _inputs(rng, 37, 45))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = fc.flash_core_fwd_plain(*leaves, H, SCALE, lse=True)
    want = torch.autograd.grad(out, leaves, g)
    got = fc.flash_core_bwd_plain(q, k, v, H, SCALE, g)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, err_msg=name)
    s = np.einsum("bhqc,bhkc->bhqk", _heads(q), _heads(k)).astype(np.float64) * SCALE
    want_lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.detach().numpy(), want_lse, atol=1e-5)


def test_flash_attention_takes_strided_views_and_returns_token_major_grads(rng):
    """The layer hands flash_attention the chunks of a fused q/k/v
    projection (strided views); values and gradients equal those of
    contiguous copies, in the token-major layout the views have."""
    x = torch.from_numpy(rng.randn(B, 40, 3 * H * C).astype(np.float32)).requires_grad_()
    q, k, v = x.chunk(3, dim=-1)
    assert not q.is_contiguous()
    out = flash_attention(q, k, v, H, SCALE)
    g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    out.backward(g)
    ref = x.detach().clone().requires_grad_()
    rq, rk, rv = (t.contiguous() for t in ref.chunk(3, dim=-1))
    fc.flash_core_fwd_plain(rq, rk, rv, H, SCALE).backward(g)
    np.testing.assert_allclose(out.detach().numpy(), fc.flash_core_fwd_plain(rq, rk, rv, H, SCALE).detach().numpy(), atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), ref.grad.numpy(), atol=1e-6)


def test_non_cuda_devices_raise_naming_the_device():
    q = torch.empty(B, 5, H * C, device="meta")
    with pytest.raises(NotImplementedError, match="no flash_core kernel for device meta"):
        fc.flash_core_fwd(q, q, q, H, SCALE)
    with pytest.raises(NotImplementedError, match="no flash_core kernel for device meta"):
        fc.flash_core_bwd(q, q, q, H, SCALE, q, q, torch.empty(B, H, 5, device="meta"))


def test_bf16_operands_with_fp32_outputs_on_the_cpu(rng):
    """out_dtype=fp32 on bf16 operands (the bf16 instances' fp32 outputs,
    GTA's sliced path) takes the plain versions on CPU tensors: fp32
    results equal to the fp32 arithmetic on the bf16 values. Other pairings
    of operand and output dtypes have no instance and raise."""
    bf = torch.bfloat16
    q, k, v, g = (_tokens(x).to(bf) for x in _inputs(rng, 37, 45))
    out, lse = fc.flash_core_fwd(q, k, v, H, SCALE, residuals=True, out_dtype=torch.float32)
    grads = fc.flash_core_bwd(q, k, v, H, SCALE, g, out, lse, out_dtype=torch.float32)
    want = fc.flash_core_fwd_plain(*(x.float() for x in (q, k, v)), H, SCALE)
    want_grads = fc.flash_core_bwd_plain(*(x.float() for x in (q, k, v)), H, SCALE, g.float())
    assert out.dtype == torch.float32 and all(x.dtype == torch.float32 for x in grads)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-7)
    for a, b, name in zip(grads, want_grads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7, err_msg=name)
    with pytest.raises(ValueError, match="no instance writes"):
        fc.flash_core_fwd(q.float(), k.float(), v.float(), H, SCALE, out_dtype=bf)
    with pytest.raises(ValueError, match="no instance writes"):
        fc.flash_core_bwd(q, k, v, H, SCALE, g, out, lse, out_dtype=torch.float16)


def test_bf16_products_on_fp32_rows_compute_as_interpret_mode_on_the_cpu(rng):
    """flash_core(..., mxu_dtype=bf16) on fp32 CPU tensors: the plain
    versions in fp32, as the JAX kernel's interpret mode computes (its
    mxu_dtype is fp32 there): the output and gradients equal those of
    mxu_dtype None, in fp32, and match the JAX kernel on the same rows."""
    q, k, v, g = _inputs(rng, 48, 600)
    got = [_tokens(x).requires_grad_() for x in (q, k, v)]
    ref = [_tokens(x).requires_grad_() for x in (q, k, v)]
    out = fc.flash_core(*got, H, SCALE, mxu_dtype=torch.bfloat16)
    out.backward(_tokens(g))
    want = fc.flash_core(*ref, H, SCALE)
    want.backward(_tokens(g))
    assert out.dtype == torch.float32 and torch.equal(out, want)
    for a, b in zip(got, ref):
        assert a.grad.dtype == torch.float32 and torch.equal(a.grad, b.grad)
    j_out = j_flash_core(*(jnp.asarray(x) for x in (q, k, v)), SCALE, True)
    np.testing.assert_allclose(_heads(out), np.asarray(j_out), atol=FWD_ATOL)
