"""The port's MoE layer against the reference's ``moe_apply`` and
``moe_dropped_fraction`` on the same weights and inputs.

Both sides must select the same experts and drop the same assignments
before outputs are compared (at rtol = atol = 1e-5). ``lax.top_k`` breaks
ties toward the lower index, which the port's stable sort matches; the
inputs are still checked to keep the k-th and (k+1)-th probabilities more
than 1e-4 apart (the near-tie rule P1), so a selection cannot hang on fp32
rounding of the router."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core.router import route as j_route
from repro.models import moe as JM
from repro_torch.configs.base import MoESpec
from repro_torch.models import moe as TM

TOL = dict(rtol=1e-5, atol=1e-5)
GAP = 1e-4


def _pair(rng, spec: MoESpec, tp: int = 1, d: int = 32):
    """Reference params (numpy, (in, out) layout) and the port's layer with
    the same weights."""
    e = TM.padded_experts(spec.n_experts, tp)
    f = spec.d_ff
    s_in, s_out = d ** -0.5, f ** -0.5
    p = {"router": rng.standard_normal((d, e)) * s_in,
         "w_gate": rng.standard_normal((e, d, f)) * s_in,
         "w_up": rng.standard_normal((e, d, f)) * s_in,
         "w_down": rng.standard_normal((e, f, d)) * s_out}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    if spec.n_shared:
        fs = spec.n_shared * f
        p["shared"] = {
            "w_gate": (rng.standard_normal((d, fs)) * s_in).astype(np.float32),
            "w_up": (rng.standard_normal((d, fs)) * s_in).astype(np.float32),
            "w_down": (rng.standard_normal((fs, d)) * fs ** -0.5
                       ).astype(np.float32)}
    layer = TM.MoE(d, spec, None, tp=tp, device="meta")
    sd = {"router": p["router"].T, "w_gate": p["w_gate"],
          "w_up": p["w_up"], "w_down": p["w_down"]}
    if spec.n_shared:
        sd.update({f"shared.{k}": v.T for k, v in p["shared"].items()})
    layer.load_state_dict({k: torch.as_tensor(np.array(v))
                           for k, v in sd.items()}, assign=True)
    jp = jax.tree.map(jnp.asarray, p)
    return jp, layer


def _skewed(rng, b, t, d, skew=2.0):
    x = rng.standard_normal((b, t, d)) + rng.standard_normal((1, 1, d)) * skew
    return x.astype(np.float32)


def _reference_dispatch(jp, x, spec, n_real):
    """The reference's routing, step for step (``moe.py:67``-``:80``)."""
    flat = jnp.asarray(x).reshape(-1, x.shape[-1])
    n, e = flat.shape[0], jp["router"].shape[1]
    cap = int(spec.capacity_factor * spec.top_k * n / (n_real or e) + 1)
    probs = j_route((flat @ jp["router"]).astype(jnp.float32), spec.router,
                    n_iter=spec.router_iters, n_real=n_real)
    _, topi = lax.top_k(probs, spec.top_k)
    eid = topi.reshape(-1)
    oh = jax.nn.one_hot(eid, e, dtype=jnp.int32)
    rank = jnp.take_along_axis(jnp.cumsum(oh, axis=0) - oh, eid[:, None],
                               axis=1)[:, 0]
    return np.asarray(probs), np.asarray(topi), np.asarray(rank), cap


def _assert_no_near_ties(probs, k):
    top = -np.sort(-probs, axis=-1)
    gap = top[:, k - 1] - top[:, k]
    assert gap.min() > GAP, f"near tie in the inputs: {gap.min()}"


@pytest.mark.parametrize("router", ["sinkhorn", "topk"])
@pytest.mark.parametrize("tp,n_shared", [(1, 1), (3, 0)])
def test_moe_apply_matches_reference(rng, router, tp, n_shared):
    """Same experts, same drop mask (skewed inputs: topk drops), same
    output and aux loss. tp=3 pads 8 experts to 9."""
    spec = MoESpec(n_experts=8, n_shared=n_shared, top_k=2, d_ff=16,
                   router=router)
    jp, layer = _pair(rng, spec, tp)
    x = _skewed(rng, 2, 16, 32)
    probs, topi, rank, cap = _reference_dispatch(jp, x, spec, 8)
    _assert_no_near_ties(probs, spec.top_k)
    flat = torch.as_tensor(x).reshape(-1, 32)
    with torch.inference_mode():
        dp = layer.dispatch(flat, router, 8)
        got, aux = layer(torch.as_tensor(x))
    assert dp.cap == cap
    np.testing.assert_array_equal(dp.topi.numpy(), topi)
    np.testing.assert_array_equal(dp.rank.numpy(), rank)
    np.testing.assert_array_equal(dp.keep.numpy() == 1, rank < cap)
    np.testing.assert_allclose(dp.probs.numpy(), probs, rtol=0, atol=1e-6)
    want, want_aux = JM.moe_apply(jp, jnp.asarray(x), spec.top_k, router,
                                  spec.capacity_factor, spec.router_iters,
                                  n_real=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    if router == "topk":
        assert (rank >= cap).any(), "the skewed inputs should drop"


def test_moe_decode_capacity_one_drops_the_same(rng):
    """qwen2-moe's decode shape: 4 tokens, 60 experts, top-4, so cap = 1
    and any expert two tokens share drops one of them."""
    spec = MoESpec(n_experts=60, n_shared=1, top_k=4, d_ff=8, router="topk")
    jp, layer = _pair(rng, spec, d=16)
    x = _skewed(rng, 4, 1, 16, skew=3.0)
    probs, topi, rank, cap = _reference_dispatch(jp, x, spec, 60)
    assert cap == 1
    _assert_no_near_ties(probs, spec.top_k)
    assert (rank >= cap).any()
    with torch.inference_mode():
        dp = layer.dispatch(torch.as_tensor(x).reshape(4, 16), "topk", 60)
        got, _ = layer(torch.as_tensor(x))
    np.testing.assert_array_equal(dp.topi.numpy(), topi)
    np.testing.assert_array_equal(dp.rank.numpy(), rank)
    want, _ = JM.moe_apply(jp, jnp.asarray(x), 4, "topk", 1.25, 6, n_real=60)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dropped_fraction_matches_reference_and_sinkhorn_drops_less(rng):
    """The reference's ``test_sinkhorn_router_reduces_drops`` shapes: the
    Sinkhorn router drops no more than softmax top-k on skewed logits."""
    spec = MoESpec(n_experts=8, n_shared=0, top_k=2, d_ff=16)
    jp, layer = _pair(rng, spec)
    x = _skewed(rng, 4, 64, 32)
    got = {}
    for kind in ("topk", "sinkhorn"):
        with torch.inference_mode():
            got[kind] = float(TM.moe_dropped_fraction(
                layer, torch.as_tensor(x), kind))
        want = float(JM.moe_dropped_fraction(jp, jnp.asarray(x), 2, kind))
        assert got[kind] == pytest.approx(want, abs=1e-7)
    assert got["sinkhorn"] <= got["topk"] + 1e-6, got
    assert got["topk"] > 0


@pytest.mark.parametrize("router", ["sinkhorn", "topk"])
def test_padded_experts_never_receive_tokens(rng, router):
    """tp=3 pads 8 experts to 9 (``padded_experts``): the padded one is
    never selected and gets no probability mass."""
    assert TM.padded_experts(60, 16) == 64 and TM.padded_experts(8, 3) == 9
    spec = MoESpec(n_experts=8, n_shared=0, top_k=2, d_ff=16, router=router)
    _, layer = _pair(rng, spec, tp=3)
    x = _skewed(rng, 3, 32, 32, skew=4.0)
    with torch.inference_mode():
        dp = layer.dispatch(torch.as_tensor(x).reshape(-1, 32), router, 8)
    assert layer.n_experts == 9
    assert (dp.topi < 8).all()
    assert (dp.probs[:, 8] == 0).all()


def test_capacity_truncates_as_the_reference():
    """``int(capacity_factor * top_k * n / (n_real or e) + 1)``: qwen2-moe
    decode at B=4 (60 real of 64 padded experts) gets one slot."""
    assert TM.capacity(4, 4, 64, 1.25, 60) == 1
    assert TM.capacity(16, 4, 60, 1.25) == 2
    assert TM.capacity(32, 2, 8, 1.25) == 11
