"""Flash attention's backward (``FlashAttention``, the reference's
``custom_vjp``) against ``jax.grad`` of the reference's
``flash_attention``, against autograd through the port's own
``attention_ref``, and under ``torch.autograd.gradcheck`` in float64. GQA
with G > 1, T over several key blocks, causal and not, q_offset > 0. fp32
gradients within rtol = atol = 1e-5."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import flash_attention as ref_flash
from repro_torch.models.layers import FlashAttention, attention_ref, \
    flash_attention

TOL = dict(rtol=1e-5, atol=1e-5)

# (B, G, Hkv, Tq, Tk, D, causal, q_offset, block_k)
CASES = [
    (2, 2, 2, 32, 32, 8, True, 0, 8),
    (2, 2, 2, 32, 32, 8, False, 0, 8),
    (1, 3, 2, 16, 32, 4, True, 16, 8),     # chunked prefill: the last 16
    (1, 1, 3, 24, 48, 8, False, 5, 16),
]


def _inputs(b, g, h, tq, tk, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, g, h, tq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    w = rng.standard_normal((b, g, h, tq, d)).astype(np.float32)
    return q, k, v, w


def _torch_grads(fn, q, k, v, w):
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fn(*ts)
    (out * torch.as_tensor(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("case", CASES)
def test_flash_grads_match_jax_grad_of_reference(case):
    b, g, h, tq, tk, d, causal, off, bk = case
    q, k, v, w = _inputs(b, g, h, tq, tk, d)
    f = functools.partial(ref_flash, causal=causal, q_offset=off, block_k=bk)

    def loss(q, k, v):
        return jnp.sum(f(q, k, v) * w)
    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    out, got = _torch_grads(
        lambda q, k, v: flash_attention(q, k, v, causal, off, bk), q, k, v, w)
    np.testing.assert_allclose(out, np.asarray(f(q, k, v)), **TOL)
    for name, x, y in zip("qkv", got, want):
        np.testing.assert_allclose(x, np.asarray(y), **TOL, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_flash_grads_match_autograd_through_attention_ref(case):
    b, g, h, tq, tk, d, causal, off, bk = case
    q, k, v, w = _inputs(b, g, h, tq, tk, d, seed=1)
    out, got = _torch_grads(
        lambda q, k, v: flash_attention(q, k, v, causal, off, bk), q, k, v, w)
    ref_out, want = _torch_grads(
        lambda q, k, v: attention_ref(q, k, v, causal, off), q, k, v, w)
    np.testing.assert_allclose(out, ref_out, **TOL)
    for name, x, y in zip("qkv", got, want):
        np.testing.assert_allclose(x, y, **TOL, err_msg=name)


@pytest.mark.parametrize("causal,off", [(True, 0), (False, 0), (True, 2)])
def test_flash_gradcheck_float64(causal, off):
    rng = np.random.default_rng(2)
    q = torch.tensor(rng.standard_normal((1, 2, 1, 4, 3)),
                     dtype=torch.float64, requires_grad=True)
    k = torch.tensor(rng.standard_normal((1, 1, 6, 3)),
                     dtype=torch.float64, requires_grad=True)
    v = torch.tensor(rng.standard_normal((1, 1, 6, 3)),
                     dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttention.apply(q, k, v, causal, off, 2),
        (q, k, v))


def test_flash_keeps_one_block_of_scores():
    """The forward saves only (q, k, v, out, lse): no (Tq, Tk) tensor."""
    q, k, v, _ = _inputs(1, 2, 1, 64, 64, 4)
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = flash_attention(*ts, True, 0, 16)
    shapes = [tuple(t.shape) for t in out.grad_fn.saved_tensors]
    assert shapes == [(1, 2, 1, 64, 4), (1, 1, 64, 4), (1, 1, 64, 4),
                      (1, 2, 1, 64, 4), (1, 2, 1, 64)]
