"""The port's LR schedule, AdamW and gradient compression against the
reference's (``repro.optim``, ``repro.runtime.compression``) on the same
numpy inputs. Schedule and AdamW within fp32 rounding (rtol 1e-6, atol
1e-7: the same formula evaluated in another order by another library);
quantization bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.optim import adamw as RA
from repro.optim.schedules import cosine_with_warmup as ref_cosine
from repro.runtime import compression as RC
from repro_torch.optim import adamw
from repro_torch.optim.schedules import cosine_with_warmup
from repro_torch.runtime import compression as C

TOL = dict(rtol=1e-6, atol=1e-7)
SCHED = dict(peak_lr=3e-4, warmup_steps=10, total_steps=110)


# steps: 0, mid-warmup, the warmup's end, mid-decay, total, past total
@pytest.mark.parametrize("step", [0, 5, 10, 60, 110, 500])
def test_cosine_with_warmup_matches_reference(step):
    want = float(ref_cosine(jnp.asarray(step, jnp.int32), **SCHED))
    got = cosine_with_warmup(torch.tensor(step, dtype=torch.int32), **SCHED)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, **TOL)


def _tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((3, 5)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal(7) * scale).astype(np.float32)},
            "d": (rng.standard_normal((2, 2, 3)) * scale).astype(np.float32)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_global_norm_matches_reference():
    g = _tree(np.random.default_rng(0), 3.0)
    want = float(RA.global_norm(g))
    got = adamw.global_norm(torch.as_tensor(v) for v in _flat(g).values())
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_adamw_three_steps_one_clipped_match_reference():
    """Three updates with the schedule's lr; the second step's gradients
    have a global norm of ~40, so its clip scales them by ~1/40."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    state = RA.init(params)
    tp = {k: torch.tensor(v) for k, v in _flat(params).items()}
    ts = adamw.init(tp)
    ref_p = params
    for i, scale in enumerate((0.05, 10.0, 0.2)):
        g = _tree(rng, scale)
        lr = ref_cosine(state.step + 1, **SCHED)
        ref_p, state, gn = RA.update(g, state, ref_p, lr)
        tlr = cosine_with_warmup(ts.step + 1, **SCHED)
        tg = {k: torch.tensor(v) for k, v in _flat(g).items()}
        tgn = adamw.update(tg, ts, tp, tlr)
        np.testing.assert_allclose(float(tgn), float(gn), rtol=1e-6)
        if i == 1:
            assert float(gn) > 1.0            # this step is clipped
        assert int(ts.step) == int(state.step) == i + 1
        for name, want in _flat(jax_np(ref_p)).items():
            np.testing.assert_allclose(tp[name].numpy(), want, **TOL)
        for name, want in _flat(jax_np(state.m)).items():
            np.testing.assert_allclose(ts.m[name].numpy(), want, **TOL)
        for name, want in _flat(jax_np(state.v)).items():
            np.testing.assert_allclose(ts.v[name].numpy(), want, **TOL)


def jax_np(tree):
    return {k: jax_np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def test_adamw_state_is_fp32_and_updates_in_place():
    p = {"w": torch.ones(4, dtype=torch.float64)}
    st_ = adamw.init(p)
    assert st_.m["w"].dtype == torch.float32
    assert st_.step.dtype == torch.int32
    w = p["w"]
    adamw.update({"w": torch.full((4,), 0.5, dtype=torch.float64)}, st_, p,
                 1e-2)
    assert p["w"] is w and float(w[0]) < 1.0


# ------------------------------------------------------------ compression
@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 1000), shape=st.sampled_from([(64,), (33,),
                                                         (128, 5), (7, 13)]))
def test_quantize_roundtrip_bounded_error(seed, shape):
    """Mirror of the reference's test: error within absmax / 127."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * 3)
    q, s = C.quantize_int8(x, block=32)
    y = C.dequantize_int8(q, s, x.shape, x.dtype)
    err = (x - y).abs().numpy()
    assert err.max() <= x.abs().max().item() / 127.0 + 1e-6


def test_error_feedback_preserves_signal():
    """Mirror: the sum of compressed grads over steps tracks the sum of
    the true grads (the error-feedback property)."""
    g = {"w": torch.full((100,), 0.003)}
    res = C.zero_residual(g)
    tot = np.zeros(100, np.float32)
    for _ in range(50):
        cg, res = C.compress_grads_with_feedback(g, res)
        tot += cg["w"].numpy()
    np.testing.assert_allclose(tot, 50 * 0.003, rtol=0.02)


@pytest.mark.parametrize("shape,block", [((64,), 32), ((33,), 32),
                                         ((128, 5), 256), ((7, 13), 8)])
def test_quantize_int8_bit_equal_to_reference(shape, block):
    x = (np.random.default_rng(2).standard_normal(shape) * 3).astype(
        np.float32)
    x.flat[0] = 0.0
    rq, rs = RC.quantize_int8(jnp.asarray(x), block)
    q, s = C.quantize_int8(torch.as_tensor(x), block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    want = RC.dequantize_int8(rq, rs, shape, jnp.float32)
    got = C.dequantize_int8(q, s, shape, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    res = {"w": torch.as_tensor(x) * 0.01}
    cg, cr = C.compress_grads_with_feedback({"w": torch.as_tensor(x)}, res,
                                            block)
    rg, rr = RC.compress_grads_with_feedback(
        {"w": jnp.asarray(x)}, {"w": jnp.asarray(res["w"].numpy())}, block)
    np.testing.assert_array_equal(cg["w"].numpy(), np.asarray(rg["w"]))
    np.testing.assert_array_equal(cr["w"].numpy(), np.asarray(rr["w"]))
