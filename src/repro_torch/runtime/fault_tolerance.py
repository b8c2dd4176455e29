"""Host-side fault tolerance for the serving runtime (port of
``repro.runtime.fault_tolerance``).

``StepGuard``     retries a step on transient failures with seeded,
                  jittered exponential backoff and classifies
                  deterministic failures (``PoisonStep``; with
                  ``check_finite``, a non-finite output) as poison that is
                  re-raised at once instead of burning the retry budget.
``DispatchGuard`` the serving extension: StepGuard's retry and backoff
                  around one engine dispatch, plus a wall-clock watchdog
                  (stragglers are counted, not silently absorbed), a
                  per-attempt hook for fault injection, and poison-request
                  classification: ``PoisonStep`` subclasses and
                  ``FloatingPointError`` (``LamUnderflowError``) are
                  deterministic per-request failures the runtime isolates.
``Heartbeat``     per-lane step-time EMA and straggler flagging; the
                  serving runtime keys its lanes by tier and reads them as
                  service-time estimates (``ema()``).
``ShardHealth``   deterministic per-shard circuit breaker for a sharded
                  fan-out: consecutive failures open a shard's circuit,
                  a counter-based probe cadence re-admits it.

Transient failures are ``RuntimeError`` and ``OSError``. On the card that
covers ``torch.cuda.OutOfMemoryError`` (a ``RuntimeError``), the CUDA
errors torch raises, and a failed launch of one of the port's kernels
(``kernels.ops`` raises ``RuntimeError``). They are retried; nothing here
answers from the CPU or from a kernel's plain version instead.

``elastic_mesh`` and ``scaled_global_batch`` are the reference's elastic
policy: the mesh for the live device count after failures (tensor
parallelism fixed, the loss absorbed by the data and pod axes), and the
global batch over the live hosts.
"""
from __future__ import annotations

import collections
import math
import random
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch


class PoisonStep(Exception):
    """Deterministic failure (NaN output, assertion): do NOT retry."""


class DispatchFailed(Exception):
    """Transient-failure retries exhausted for one dispatch.

    Deliberately NOT a RuntimeError: outer guards classify RuntimeError as
    transient-and-retryable, and a dispatch that already consumed its own
    retry budget must not be retried again upstream."""


def _leaves(out):
    """The leaves of a nested container, in the reference's pytree order:
    tuples (NamedTuples included) and lists in order, dicts by sorted key
    (an ``OrderedDict`` in its own order), ``None`` holds no leaf."""
    if out is None:
        return
    if isinstance(out, (tuple, list)):
        for x in out:
            yield from _leaves(x)
    elif isinstance(out, dict):
        keys = (list(out) if isinstance(out, collections.OrderedDict)
                else sorted(out))
        for key in keys:
            yield from _leaves(out[key])
    else:
        yield out


def _nonfinite_leaves(out) -> list[str]:
    """Names (``leaf[i]``) of float leaves with any non-finite entry.

    A tensor is tested where it lies: on the card the test runs there and
    one bool is copied back, not the tensor. Each float tensor on the card
    costs one sync, so callers guarding large outputs should leave
    ``check_finite`` off and check a cheap scalar themselves; serving
    dispatches return small host arrays."""
    bad = []
    for i, leaf in enumerate(_leaves(out)):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() \
                    and not bool(torch.isfinite(leaf).all()):
                bad.append(f"leaf[{i}]")
            continue
        try:
            arr = np.asarray(leaf)
        except (TypeError, ValueError):
            continue
        if np.issubdtype(arr.dtype, np.floating) \
                and not np.isfinite(arr).all():
            bad.append(f"leaf[{i}]")
    return bad


@dataclass
class StepGuard:
    """Retry-on-transient-failure wrapper with poison classification.

    ``check_finite=True`` additionally classifies a step whose OUTPUT
    contains NaN/inf float leaves as :class:`PoisonStep`: a deterministic
    NaN re-runs identically, so retrying it ``max_retries`` times only
    delays the inevitable. Off by default: the finite check syncs every
    float leaf on the card (see :func:`_nonfinite_leaves`).

    Backoff is ``backoff_s * 2**attempt * (1 + jitter * U[0,1))`` with the
    uniform draw from a ``seed``-deterministic stream: reproducible in
    tests, desynchronized across a fleet.
    """

    max_retries: int = 3
    backoff_s: float = 1.0
    jitter: float = 0.25
    seed: int = 0
    check_finite: bool = False

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def _sleep(self, attempt: int) -> None:
        time.sleep(self.backoff_s * (2 ** attempt)
                   * (1.0 + self.jitter * self._rng.random()))

    def run(self, step_fn, *args):
        """Run step_fn; retry transient failures with jittered backoff;
        re-raise deterministic poison immediately."""
        last = None
        for attempt in range(self.max_retries + 1):
            try:
                out = step_fn(*args)
                if self.check_finite:
                    bad = _nonfinite_leaves(out)
                    if bad:
                        raise PoisonStep(
                            f"non-finite step output ({', '.join(bad)}): "
                            "deterministic failure, not retried")
                return out
            except PoisonStep:
                raise
            except (RuntimeError, OSError) as e:
                last = e
                if attempt < self.max_retries:
                    self._sleep(attempt)
        raise RuntimeError(
            f"step failed after {self.max_retries + 1} attempts") from last


@dataclass
class DispatchGuard(StepGuard):
    """Serving dispatch guard: retry/timeout/backoff around ONE engine
    dispatch.

    Extends :class:`StepGuard` with:

    - *poison-request classification*: ``PoisonStep`` subclasses AND
      ``FloatingPointError`` (``repro_torch.core.sinkhorn.LamUnderflowError``)
      are deterministic per-request failures, re-raised immediately so
      the serving runtime can fall back to per-request isolation and
      return a structured error for the poisoned request while its
      batchmates still get answers;
    - *wall-clock watchdog*: a dispatch (successful or not) that exceeds
      ``watchdog_s`` increments ``watchdog_trips``, and the runtime tags
      the affected responses as straggler-served. Cooperative: a running
      dispatch cannot be preempted from Python, so the watchdog classifies
      and accounts rather than kills (a straggling attempt still counts
      against the retry budget);
    - *per-attempt hook* ``before_attempt(tag, attempt)``: the fault
      injector's entry point (latency/transient injection runs inside the
      guarded region, so the retry path is exercised, not simulated).

    Counters (``retries``, ``watchdog_trips``) accumulate across calls:
    one guard instance per runtime, read by ``stats()``.
    """

    watchdog_s: float = 5.0
    before_attempt: Callable | None = None
    retries: int = field(default=0, init=False)
    watchdog_trips: int = field(default=0, init=False)

    def run(self, fn, *args, tag: int = 0):
        last = None
        for attempt in range(self.max_retries + 1):
            t0 = time.monotonic()
            try:
                if self.before_attempt is not None:
                    self.before_attempt(tag, attempt)
                out = fn(*args)
                if time.monotonic() - t0 > self.watchdog_s:
                    self.watchdog_trips += 1
                return out
            except (PoisonStep, FloatingPointError):
                raise          # deterministic: isolate, never retry
            except (RuntimeError, OSError) as e:
                last = e
                if time.monotonic() - t0 > self.watchdog_s:
                    self.watchdog_trips += 1
                self.retries += 1
                if attempt < self.max_retries:
                    self._sleep(attempt)
        raise DispatchFailed(
            f"dispatch failed after {self.max_retries + 1} attempts "
            f"({type(last).__name__}: {last})") from last


@dataclass
class Heartbeat:
    """Step-time tracking + straggler flagging: an EMA per lane (a host,
    or for the serving runtime a tier) and strikes against lanes slower
    than ``threshold`` times the median for ``patience`` checks."""
    threshold: float = 1.5
    patience: int = 5
    ema_alpha: float = 0.2
    _ema: dict = field(default_factory=dict)
    _strikes: dict = field(default_factory=dict)

    def record(self, host_id: int, step_time_s: float) -> None:
        prev = self._ema.get(host_id, step_time_s)
        self._ema[host_id] = (1 - self.ema_alpha) * prev \
            + self.ema_alpha * step_time_s

    def ema(self, host_id: int) -> float | None:
        """Current smoothed step time for one lane (``None`` before the
        first record). The serving runtime keys lanes by degradation TIER
        and reads this as the tier's expected service time when deciding
        whether a request's remaining deadline budget still affords it."""
        return self._ema.get(host_id)

    def stragglers(self) -> list[int]:
        if len(self._ema) < 2:
            return []
        times = sorted(self._ema.values())
        median = times[len(times) // 2]
        out = []
        for host, t in self._ema.items():
            if t > self.threshold * median:
                self._strikes[host] = self._strikes.get(host, 0) + 1
                if self._strikes[host] >= self.patience:
                    out.append(host)
            else:
                self._strikes[host] = 0
        return out


@dataclass
class ShardHealth:
    """Deterministic per-shard circuit breaker.

    Drives a sharded engine's fan-out admission: a shard that fails
    ``fail_threshold`` consecutive dispatches has its circuit OPENED and
    is skipped (its docs drop out of coverage); every ``probe_every``-th
    skipped fan-out the shard is probed (one real dispatch), and a
    successful probe closes the circuit and re-admits it. The cadence is
    a pure counter, not a timer or a random draw, so a chaos drill with
    a fixed fault schedule replays the identical skip/probe/re-admit
    sequence every run.

    Also keeps a service-time EMA per shard (successful dispatches only),
    exposed via :meth:`stats`.
    """

    n_shards: int
    fail_threshold: int = 3
    probe_every: int = 4
    ema_alpha: float = 0.3

    def __post_init__(self):
        n = self.n_shards
        self._consecutive = [0] * n
        self._open = [False] * n
        self._skips = [0] * n
        self._ema: dict = {}
        self.failures = [0] * n      # total failed dispatches per shard
        self.successes = [0] * n
        self.probes = [0] * n        # dispatches admitted through an open circuit
        self.opened = [0] * n        # times the circuit tripped open

    def admit(self, shard: int) -> bool:
        """Should this fan-out dispatch to ``shard``? Closed circuit:
        always. Open circuit: every ``probe_every``-th call (a probe)."""
        if not self._open[shard]:
            return True
        self._skips[shard] += 1
        if self._skips[shard] % self.probe_every == 0:
            self.probes[shard] += 1
            return True
        return False

    def record_success(self, shard: int, service_s: float) -> None:
        """A dispatch answered: reset strikes, close the circuit (a
        successful probe re-admits the shard), update the EMA."""
        self.successes[shard] += 1
        self._consecutive[shard] = 0
        self._open[shard] = False
        self._skips[shard] = 0
        prev = self._ema.get(shard, service_s)
        self._ema[shard] = (1 - self.ema_alpha) * prev \
            + self.ema_alpha * service_s

    def record_failure(self, shard: int) -> None:
        """A dispatch timed out or errored: one strike; at
        ``fail_threshold`` consecutive strikes the circuit opens."""
        self.failures[shard] += 1
        self._consecutive[shard] += 1
        if self._consecutive[shard] >= self.fail_threshold \
                and not self._open[shard]:
            self._open[shard] = True
            self._skips[shard] = 0
            self.opened[shard] += 1

    def reset(self, shard: int) -> None:
        """Forget a shard's history, after a snapshot restore rejoins it
        (the restored shard is a new process; its predecessor's strikes
        are not its own)."""
        self._consecutive[shard] = 0
        self._open[shard] = False
        self._skips[shard] = 0
        self._ema.pop(shard, None)

    def is_open(self, shard: int) -> bool:
        return self._open[shard]

    @property
    def open_shards(self) -> tuple:
        return tuple(i for i in range(self.n_shards) if self._open[i])

    def ema(self, shard: int) -> float | None:
        """Smoothed service time for one shard (None before first success)."""
        return self._ema.get(shard)

    def stats(self) -> dict:
        return {
            "open": list(self.open_shards),
            "failures": list(self.failures),
            "successes": list(self.successes),
            "probes": list(self.probes),
            "opened": list(self.opened),
            "ema_s": {s: round(v, 6) for s, v in sorted(self._ema.items())},
        }


def elastic_mesh(n_devices: int, model_parallel: int = 8,
                 pod_size: int = 256, devices=None):
    """The mesh for the LIVE device count (the survivors after failures),
    the reference's arithmetic and axis names: tensor parallelism stays
    ``model_parallel`` (the weights are sharded that way; resharding it is
    the expensive path) and the loss is absorbed by the data and pod axes.
    Past one pod, and with whole pods, ``("pod", "data", "model")``, else
    ``("data", "model")``. ``n_devices`` must be a multiple of
    ``model_parallel``. The default TP of 8 is one 8-GPU NVLink node (the
    reference's 16 is a TPU pod's). Positions are dealt over ``devices``
    as ``runtime.sharding.make_mesh`` deals them (default: the visible
    CUDA devices; raises without one)."""
    from repro_torch.runtime.sharding import make_mesh
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"TP={model_parallel}")
    rest = n_devices // model_parallel
    if n_devices > pod_size and rest % (pod_size // model_parallel) == 0:
        return make_mesh((n_devices // pod_size, pod_size // model_parallel,
                          model_parallel), ("pod", "data", "model"), devices)
    return make_mesh((rest, model_parallel), ("data", "model"), devices)


def scaled_global_batch(base_batch: int, base_hosts: int,
                        live_hosts: int, keep_global: bool = True) -> int:
    """Elastic batch policy: keep the global batch (the per-host batch
    grows) or scale it with the fleet (exact per-host batch; the caller
    rescales the learning rate)."""
    if keep_global:
        per = math.ceil(base_batch / live_hosts)
        return per * live_hosts
    return (base_batch // base_hosts) * live_hosts
