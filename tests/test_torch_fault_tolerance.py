"""The port's host-side fault tolerance (``repro_torch.runtime.
fault_tolerance``): the reference's guard tests (``tests/test_fault_
tolerance.py``) and circuit-breaker units (``tests/test_shard_fault.py``)
run against the port, and the non-finite leaf walk and the retry
classification are held against the reference on the same inputs.

Nothing here touches a device: the guards are host Python, and every
comparison with the reference is exact (names, counts, sleep schedules).
"""
import collections
import time
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro.runtime import fault_tolerance as ref_ft
from repro_torch.core.sinkhorn import LamUnderflowError
from repro_torch.runtime.fault_tolerance import (DispatchFailed,
                                                 DispatchGuard, Heartbeat,
                                                 PoisonStep, ShardHealth,
                                                 StepGuard,
                                                 _nonfinite_leaves)


def test_stepguard_nonfinite_output_is_poison():
    """check_finite classifies a NaN output as PoisonStep on the FIRST
    attempt: a deterministic NaN re-runs identically, so retrying only
    burns the backoff schedule."""
    calls = {"n": 0}

    def nan_step():
        calls["n"] += 1
        return {"loss": torch.tensor(float("nan")), "ok": torch.ones(3)}

    with pytest.raises(PoisonStep):
        StepGuard(backoff_s=0.0, check_finite=True).run(nan_step)
    assert calls["n"] == 1      # no retries burned on a deterministic NaN


def test_stepguard_finite_output_passes():
    out = StepGuard(backoff_s=0.0, check_finite=True).run(
        lambda: {"loss": torch.tensor(1.5), "ids": torch.arange(3)})
    assert float(out["loss"]) == 1.5


def test_stepguard_check_finite_off_by_default():
    """Default guards do not pay the per-leaf sync: NaN outputs pass
    through un-poisoned."""
    out = StepGuard(backoff_s=0.0).run(lambda: np.float32("nan"))
    assert np.isnan(out)


def test_stepguard_backoff_jittered_and_seeded(monkeypatch):
    """Backoff sleeps follow base * 2^attempt * (1 + jitter*U[0,1)) from
    a seed-deterministic stream: reproducible, never below the
    exponential floor, never above the jitter ceiling, and equal to the
    reference's schedule for the same seed."""
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)

    def run_once(guard_cls):
        slept.clear()
        g = guard_cls(max_retries=3, backoff_s=0.1, jitter=0.5, seed=42)
        with pytest.raises(RuntimeError):
            g.run(lambda: (_ for _ in ()).throw(RuntimeError("transient")))
        return list(slept)

    a, b = run_once(StepGuard), run_once(StepGuard)
    assert a == b                       # seeded: identical schedules
    assert len(a) == 3                  # sleeps between 4 attempts
    for attempt, s in enumerate(a):
        base = 0.1 * 2 ** attempt
        assert base <= s <= base * 1.5, (attempt, s)
    assert a[0] != a[1] / 2             # jitter actually applied
    assert a == run_once(ref_ft.StepGuard)   # bit for bit


def test_dispatchguard_poison_never_retried():
    """PoisonStep subclasses AND FloatingPointError (LamUnderflowError)
    are deterministic per-request failures: re-raised on attempt 0."""
    for exc in (PoisonStep("injected"), LamUnderflowError("lam too hot"),
                FloatingPointError("underflow")):
        calls = {"n": 0}

        def bad():
            calls["n"] += 1
            raise exc

        g = DispatchGuard(backoff_s=0.0)
        with pytest.raises(type(exc)):
            g.run(bad)
        assert calls["n"] == 1, type(exc)
        assert g.retries == 0


def test_dispatchguard_transient_retried_to_success():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    g = DispatchGuard(backoff_s=0.0)
    assert g.run(flaky) == "ok"
    assert g.retries == 2


def test_dispatchguard_exhaustion_is_dispatchfailed():
    """Retries exhausted raises DispatchFailed, deliberately NOT a
    RuntimeError, so an outer guard cannot re-classify it transient."""
    g = DispatchGuard(max_retries=2, backoff_s=0.0)
    with pytest.raises(DispatchFailed) as ei:
        g.run(lambda: (_ for _ in ()).throw(RuntimeError("down")))
    assert not isinstance(ei.value, RuntimeError)
    assert "3 attempts" in str(ei.value)
    assert g.retries == 3


def test_dispatchguard_watchdog_counts_stragglers():
    g = DispatchGuard(watchdog_s=0.01, backoff_s=0.0)
    g.run(lambda: time.sleep(0.03) or "slow")
    assert g.watchdog_trips == 1
    g.run(lambda: "fast")
    assert g.watchdog_trips == 1        # fast dispatch: no trip


def test_dispatchguard_before_attempt_hook_inside_guard():
    """The injection hook runs INSIDE the guarded region: a hook that
    raises a transient error consumes a retry, and the hook sees the
    (tag, attempt) pair for each attempt."""
    seen = []

    def hook(tag, attempt):
        seen.append((tag, attempt))
        if attempt == 0:
            raise RuntimeError("injected")

    g = DispatchGuard(backoff_s=0.0, before_attempt=hook)
    assert g.run(lambda: "ok", tag=5) == "ok"
    assert seen == [(5, 0), (5, 1)]
    assert g.retries == 1


def test_heartbeat_ema_accessor():
    hb = Heartbeat(ema_alpha=0.5)
    assert hb.ema(0) is None            # no record yet
    hb.record(0, 2.0)
    assert hb.ema(0) == pytest.approx(2.0)
    hb.record(0, 4.0)
    assert hb.ema(0) == pytest.approx(3.0)
    assert hb.ema(1) is None            # lanes are independent


# ---------------------------------------------- the port's transient class
@pytest.mark.parametrize("exc", [
    torch.cuda.OutOfMemoryError("CUDA out of memory (injected)"),
    RuntimeError("rwmd_min_cdist launch failed: cudaError 700"),
    OSError("injected I/O error")], ids=["oom", "launch", "oserror"])
def test_dispatchguard_retries_cuda_failures(exc):
    """What the card raises is retried as transient: torch's CUDA
    out-of-memory error (a RuntimeError, as XLA's resource errors are
    retried by the reference) and a failed kernel launch (the wrappers
    raise RuntimeError)."""
    calls = {"n": 0}

    def body():
        calls["n"] += 1
        if calls["n"] == 1:
            raise exc
        return "ok"

    g = DispatchGuard(backoff_s=0.0)
    assert g.run(body) == "ok"
    assert g.retries == 1 and calls["n"] == 2


# ------------------------------------------ non-finite leaves vs reference
class _Res(NamedTuple):
    indices: object
    distances: object


def _nested(nan_at: set, as_torch: bool):
    """The same nested output as numpy (for the reference's pytree walk)
    or torch (for the port's): a dict of a tuple, a list, a NamedTuple
    and an OrderedDict, with NaN or inf planted at the float leaves
    named in ``nan_at``."""
    vals = {}
    for name in ("a", "b", "c", "d", "e", "f"):
        x = np.arange(4, dtype=np.float32)
        if name in nan_at:
            x[2] = np.nan if name < "d" else np.inf
        vals[name] = torch.from_numpy(x) if as_torch else x
    ids = torch.arange(3) if as_torch else np.arange(3)
    return {
        "z": (vals["a"], None, [vals["b"], 7]),
        "m": _Res(ids, vals["c"]),
        "b": collections.OrderedDict([("y", vals["d"]), ("x", vals["e"])]),
        "a": [np.float32(np.nan) if "f" in nan_at else np.float32(1.0),
              "label", vals["f"]],
    }


@pytest.mark.parametrize("nan_at", [set(), {"a"}, {"b", "e"},
                                    {"c", "d", "f"},
                                    {"a", "b", "c", "d", "e", "f"}],
                         ids=["none", "a", "b_e", "c_d_f", "all"])
def test_nonfinite_leaves_names_match_reference(nan_at):
    """Same ``leaf[i]`` names as the reference's JAX pytree walk (dict
    keys sorted, OrderedDict in its own order, NamedTuple fields in
    order, None holding no leaf); exact."""
    got = _nonfinite_leaves(_nested(nan_at, as_torch=True))
    want = ref_ft._nonfinite_leaves(_nested(nan_at, as_torch=False))
    assert got == want
    assert bool(got) == bool(nan_at)


def test_nonfinite_leaves_integer_and_bf16_tensors():
    """Integer tensors are never flagged; a bf16 tensor is a float leaf."""
    bad = torch.tensor([1.0, float("inf")], dtype=torch.bfloat16)
    assert _nonfinite_leaves((torch.arange(3), bad)) == ["leaf[1]"]


# ------------------------------------------------------ circuit breaker
def test_health_opens_at_consecutive_threshold():
    h = ShardHealth(2, fail_threshold=3)
    for _ in range(2):
        h.record_failure(0)
    assert not h.is_open(0)
    h.record_success(0, 0.01)          # success resets the strike count
    for _ in range(2):
        h.record_failure(0)
    assert not h.is_open(0)
    h.record_failure(0)
    assert h.is_open(0) and h.opened[0] == 1
    assert h.open_shards == (0,)
    assert not h.is_open(1)            # per-shard state, not global


def test_health_probe_cadence_is_deterministic():
    h = ShardHealth(1, fail_threshold=1, probe_every=3)
    h.record_failure(0)
    admits = [h.admit(0) for _ in range(6)]
    assert admits == [False, False, True, False, False, True]
    assert h.probes[0] == 2


def test_health_successful_probe_closes_circuit():
    h = ShardHealth(1, fail_threshold=1, probe_every=1)
    h.record_failure(0)
    assert h.is_open(0) and h.admit(0)     # probe admitted
    h.record_success(0, 0.02)
    assert not h.is_open(0)
    assert all(h.admit(0) for _ in range(4))


def test_health_ema_reset_and_stats():
    h = ShardHealth(2, ema_alpha=0.5)
    assert h.ema(0) is None
    h.record_success(0, 0.1)
    assert h.ema(0) == pytest.approx(0.1)
    h.record_success(0, 0.3)
    assert h.ema(0) == pytest.approx(0.2)   # 0.5*0.1 + 0.5*0.3
    h.record_failure(1)
    st = h.stats()
    assert st["successes"] == [2, 0] and st["failures"] == [0, 1]
    h.reset(0)
    assert h.ema(0) is None and not h.is_open(0)
