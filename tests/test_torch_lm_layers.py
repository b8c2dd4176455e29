"""The port's LM layers and Sinkhorn MoE router against the reference
(``repro.models.layers``, ``repro.core.router``) on the same numpy inputs.

Layers are held at rtol = atol = 1e-5 and the router at atol 1e-6 (both
sides compute in fp32 and sum in different orders). Dense weights are
carried in the reference's (in, out) layout and transposed into the port's
``nn.Linear`` layout, as ``repro_torch.models.convert`` does."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import router as JR
from repro.models import layers as JL
from repro_torch.core import router as TR
from repro_torch.models import layers as TL

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(rng, kind):
    x = _normal(rng, 3, 7, 64, scale=3.0)
    p = {"scale": _normal(rng, 64)}
    if kind == "layernorm":
        p["bias"] = _normal(rng, 64)
    want = JL.apply_norm(kind, {k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    norm = TL.Norm(kind, 64, device="cpu")
    norm.load_state_dict({k: _t(v) for k, v in p.items()})
    _close(norm(_t(x)), want)


def test_rope_matches_reference(rng):
    pos = np.array([0, 1, 5, 17, 300], np.int32)
    cos, sin = TL.rope_frequencies(16, 10000.0, torch.as_tensor(pos))
    jcos, jsin = JL.rope_frequencies(16, 10000.0, jnp.asarray(pos))
    _close(cos, jcos, rtol=1e-6, atol=1e-6)
    _close(sin, jsin, rtol=1e-6, atol=1e-6)
    x = _normal(rng, 2, 3, 5, 16)
    _close(TL.apply_rope(_t(x), cos, sin),
           JL.apply_rope(jnp.asarray(x), jcos, jsin))


@pytest.mark.parametrize("causal,q_offset,tq", [(True, 0, 32), (False, 0, 32),
                                                (True, 24, 8)])
def test_flash_attention_matches_twin_and_reference(rng, causal, q_offset,
                                                    tq):
    """Four key blocks of 8, GQA g=2; the online-softmax loop against the
    materialized twin and against the reference's flash attention."""
    q = _normal(rng, 2, 2, 3, tq, 16)
    k = _normal(rng, 2, 3, 32, 16)
    v = _normal(rng, 2, 3, 32, 16)
    got = TL.flash_attention(_t(q), _t(k), _t(v), causal, q_offset, 8)
    twin = TL.attention_ref(_t(q), _t(k), _t(v), causal, q_offset)
    torch.testing.assert_close(got, twin, **TOL)
    want = JL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal, q_offset, 8)
    _close(got, want)
    _close(twin, JL.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal, q_offset))


def _attention_pair(rng, n_q, n_kv, bias, theta=10000.0, d=64, hd=16):
    """The reference's attention params and the port's module holding the
    same weights (random biases, which the reference's init leaves 0)."""
    p = {"wq": _normal(rng, d, n_q * hd, scale=d ** -0.5),
         "wk": _normal(rng, d, n_kv * hd, scale=d ** -0.5),
         "wv": _normal(rng, d, n_kv * hd, scale=d ** -0.5),
         "wo": _normal(rng, n_q * hd, d, scale=d ** -0.5)}
    if bias:
        p.update(bq=_normal(rng, n_q * hd), bk=_normal(rng, n_kv * hd),
                 bv=_normal(rng, n_kv * hd))
    mod = TL.Attention(d, n_q, n_kv, hd, bias, theta, None, device="meta")
    mod.load_state_dict({k: _t(v.T if v.ndim == 2 else v)
                         for k, v in p.items()}, assign=True)
    return {k: jnp.asarray(v) for k, v in p.items()}, mod


@pytest.mark.parametrize("n_q,n_kv,bias", [(4, 4, False), (8, 2, True)])
def test_attention_prefill_matches_reference(rng, n_q, n_kv, bias):
    """GQA (g=4) shows a q-major head layout, which would permute heads."""
    p, mod = _attention_pair(rng, n_q, n_kv, bias)
    x = _normal(rng, 2, 24, 64)
    want = JL.attention_train(p, jnp.asarray(x), n_q, n_kv, 16, 10000.0,
                              block_k=8)
    with torch.inference_mode():
        _close(mod(_t(x), block_k=8), want)


@pytest.mark.parametrize("n_q,n_kv,bias,theta", [
    (4, 4, False, 10000.0), (8, 2, True, 1e6), (4, 2, False, None)])
def test_attention_decode_matches_reference(rng, n_q, n_kv, bias, theta):
    """A half-filled cache of 12 slots, decode at pos 6: output and the
    written cache slot."""
    p, mod = _attention_pair(rng, n_q, n_kv, bias, theta)
    x = _normal(rng, 2, 1, 64)
    ck = _normal(rng, 2, n_kv, 12, 16)
    cv = _normal(rng, 2, n_kv, 12, 16)
    ck[:, :, 7:] = 0.0
    cv[:, :, 7:] = 0.0
    want, wk, wv = JL.attention_decode(p, jnp.asarray(x), jnp.asarray(ck),
                                       jnp.asarray(cv), jnp.asarray(6),
                                       n_q, n_kv, 16, theta)
    tk, tv = _t(ck), _t(cv)
    with torch.inference_mode():
        got = mod.decode(_t(x), tk, tv, 6)
    _close(got, want)
    _close(tk, wk)
    _close(tv, wv)


def test_decode_past_cache_raises(rng):
    """The reference's dynamic_update_slice clamps a write at pos >= S onto
    the last slot; the port raises instead."""
    _, mod = _attention_pair(rng, 4, 4, False)
    ck = torch.zeros(1, 4, 4, 16)
    with torch.inference_mode(), pytest.raises(IndexError, match="outside"):
        mod.decode(torch.zeros(1, 1, 64), ck, ck.clone(), 4)


@pytest.mark.parametrize("kind", ["swiglu", "squared_relu", "gelu"])
def test_mlps_match_reference(rng, kind):
    """gelu is the tanh approximation, ``jax.nn.gelu``'s default."""
    d, f = 64, 128
    if kind == "swiglu":
        p = {"w_gate": _normal(rng, d, f, scale=d ** -0.5),
             "w_up": _normal(rng, d, f, scale=d ** -0.5),
             "w_down": _normal(rng, f, d, scale=f ** -0.5)}
    else:
        p = {"w_in": _normal(rng, d, f, scale=d ** -0.5),
             "w_out": _normal(rng, f, d, scale=f ** -0.5)}
    x = _normal(rng, 3, 5, d, scale=2.0)
    want = JL.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                  kind)
    mod = TL.MLP(d, f, kind, None, device="meta")
    mod.load_state_dict({k: _t(v.T) for k, v in p.items()}, assign=True)
    with torch.inference_mode():
        _close(mod(_t(x)), want)


# ------------------------------------------------------------------ router
@pytest.mark.parametrize("shape,n_real", [((32, 8), None), ((32, 8), 6),
                                          ((3, 20, 16), 13)])
def test_sinkhorn_route_matches_reference(rng, shape, n_real):
    logits = _normal(rng, *shape, scale=5.0)
    got = TR.sinkhorn_route(_t(logits), n_iter=6, n_real=n_real)
    want = JR.sinkhorn_route(jnp.asarray(logits), n_iter=6, n_real=n_real)
    _close(got, want, rtol=0, atol=1e-6)
    assert torch.isfinite(got).all()
    if n_real is not None:
        assert (got[..., n_real:] == 0).all()


@pytest.mark.parametrize("kind", ["sinkhorn", "topk"])
@pytest.mark.parametrize("n_real", [None, 5])
def test_route_matches_reference(rng, kind, n_real):
    """Padded experts (n_real < E) get logit -1e30 and no probability."""
    logits = _normal(rng, 24, 8, scale=3.0)
    got = TR.route(_t(logits), kind, n_iter=6, n_real=n_real)
    want = JR.route(jnp.asarray(logits), kind, n_iter=6, n_real=n_real)
    _close(got, want, rtol=0, atol=1e-6)
    if n_real is not None:
        assert (got[:, n_real:] == 0).all()
    with pytest.raises(ValueError, match="router kind"):
        TR.route(_t(logits), "expert_choice")


def test_logsumexp_keeps_dead_columns_at_minus_inf():
    """The update the router relies on: an all -inf slice gives -inf, not
    NaN, so a dead expert's g stays -inf."""
    x = torch.full((4, 3), -torch.inf)
    assert torch.isneginf(torch.logsumexp(x, dim=0)).all()
    plan = TR.sinkhorn_route(torch.zeros(4, 3), n_iter=3, n_real=2)
    assert torch.isfinite(plan).all() and (plan[:, 2] == 0).all()
