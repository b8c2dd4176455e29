"""Fault-tolerant async serving runtime around :class:`WmdEngine` (port of
``repro.runtime.serving``).

``ServingRuntime``
    asyncio request queue + micro-batch coalescer. Incoming requests are
    grouped by the engine's pow2 ``v_r`` buckets
    (:func:`repro_torch.core.index.bucket_size`: one dispatch is one solver
    chunk shape) and a bucket dispatches under the DEADLINE-OR-FULL rule:
    as soon as it holds ``max_batch`` requests, or when its oldest member
    has waited ``window_s``. Dispatches run on a single worker thread (one
    device, serialized), so the event loop keeps admitting and coalescing
    while the solver runs.

Admission control & backpressure
    The queue is bounded (``max_queue`` counts queued + coalescing +
    in-flight). An arrival over the bound gets an immediate structured
    ``rejected_overload`` response (with a ``retry_after_s`` hint), the
    only case that is ever *refused*. Under pressure the runtime DEGRADES
    instead of dropping: the dispatch tier falls back queue-depth-wise
    (``degrade_depth`` watermarks) and deadline-wise (a batch whose
    tightest remaining budget cannot afford a tier's measured service-time
    EMA falls to the next tier; a blown deadline serves the cheapest tier
    rather than nothing). Every response is tagged with the tier that
    served it and that tier's measured-recall caveat.

Degradation ladder (cheapest-last)
    1. ``exact``          full cascade, ``nprobe = all``: exact top-k.
    2. ``reduced_nprobe`` same cascade, fewer probed clusters:
       approximate, recall monotone in nprobe (fig9). Exists only when
       the engine's prune spec is an IVF cascade.
    3. ``refine``         rank-then-refine (``mode="refine"``): rank every
       candidate by the cascade's tightest lower bound, Sinkhorn-solve
       only each query's top ``refine_factor * k`` picks. Distances of
       the reported top-k ARE exact truncated-Sinkhorn scores; only
       membership is approximate, recall monotone in ``refine_factor``
       (fig13).
    4. ``rwmd``           rank by the RWMD lower bound with NO Sinkhorn
       solve (LC-RWMD, Atasu et al. arXiv 1711.07227): one min-cdist
       (K2 on the card) + O(nnz) gather per chunk, bound values returned
       as distances.

Cross-request K-column cache
    The runtime enables the engine's cross-request cdist-row cache by
    default (``ServeConfig.kcache_slots``; ``core/kcache.py``) on an
    engine that can host one. The port's default engine is
    ``impl="kernel"``, whose ``enable_kcache`` refuses (as the reference
    engine's kernel impl does), so a runtime over a default engine serves
    without the cache; an ``impl="sparse"`` engine gets it. Results are
    bit-exact either way; hit/miss counters land in
    :meth:`ServingRuntime.stats` and each response carries its own
    dispatch's delta (``ServeResponse.kcache``).

Fault tolerance
    Each dispatch runs under a
    :class:`~repro_torch.runtime.fault_tolerance.DispatchGuard`: transient
    failures (``RuntimeError``/``OSError``, which covers CUDA errors,
    ``torch.cuda.OutOfMemoryError`` and a failed kernel launch) retry with
    jittered exponential backoff; a wall-clock watchdog counts straggler
    dispatches; DETERMINISTIC failures (``LamUnderflowError``,
    ``PoisonStep``) trigger per-request isolation: the batch re-solves
    one request at a time, poisoned requests get a structured error
    response (underflow diagnostics attached) and their batchmates still
    get answers. Retries exhausted => structured ``retries_exhausted``
    errors, never an unhandled exception: every submitted request's
    future resolves to a :class:`ServeResponse`. No path answers from the
    CPU or from a kernel's plain version in place of the card.

Shard coverage
    An engine that reports ``last_coverage``
    (:class:`~repro_torch.core.shard_index.ShardCoverage`) gets its
    partial results tagged ``partial``/``coverage``/``missing_shards``,
    its caveat extended, and ``exact`` forced ``False``; an all-shards
    failure (:class:`~repro_torch.core.shard_index.ShardSearchError`)
    becomes a structured ``shard_failed`` error.
    :meth:`ServingRuntime.request_shutdown` drains gracefully on
    SIGTERM/SIGINT: admitted requests resolve, the rest get structured
    ``shutting_down`` rejections.

``FaultInjector``
    Seeded, deterministic chaos hooks: stage latency, transient dispatch
    faults and per-request poison, each an order-independent pure
    function of ``(seed, site)`` (counter-based RNG streams), so a chaos
    run replays identically from its seed.

Typical use::

    runtime = ServingRuntime(engine, ServeConfig(max_batch=8,
                                                 window_s=0.01))
    responses, stats = run_open_loop(runtime, queries,
                                     arrivals_s=poisson_arrivals(...))

or inside an event loop::

    await runtime.start()
    fut = runtime.submit(query, k=10, deadline_s=0.25)
    resp = await fut          # always resolves; resp.ok or resp.error
    await runtime.stop()

The runtime runs on the engine's device: the card unless the index was
built with ``device="cpu"``.
"""
from __future__ import annotations

import asyncio
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import NamedTuple, Sequence

import numpy as np

from repro_torch.core.index import WmdEngine, bucket_size
from repro_torch.core.shard_index import ShardSearchError
from repro_torch.core.sinkhorn import LamUnderflowError
from repro_torch.runtime.fault_tolerance import (DispatchFailed,
                                                 DispatchGuard, Heartbeat,
                                                 PoisonStep)


class PoisonRequest(PoisonStep):
    """Deterministic per-request failure (injected or diagnosed): the
    request must be structured-errored, never retried."""

    def __init__(self, rid: int, message: str):
        super().__init__(message)
        self.rid = rid


# ----------------------------------------------------------------- tiers
def _ivf_cluster_count(engine) -> int | None:
    """IVF cluster count backing the nprobe ladder: the engine's own
    count, or the SMALLEST per-shard count for a sharded engine (nprobe
    clamps per shard, so sizing against the minimum keeps the reduced
    tier a genuine reduction on every shard). None when un-clustered."""
    counts = getattr(engine, "cluster_counts", None)
    if counts:
        return int(min(counts))
    clusters = getattr(getattr(engine, "index", None), "clusters", None)
    return None if clusters is None else int(clusters.n_clusters)


class Tier(NamedTuple):
    """One rung of the degradation ladder."""

    name: str
    nprobe: int | None   # None = all probed clusters (exact cascade)
    solve: bool          # False: rank by the RWMD bound, no Sinkhorn
    caveat: str          # recall semantics, attached to every response
    mode: str = "exact"  # engine search mode ("exact" | "refine")
    refine_factor: int | None = None  # solve budget multiple (refine)


def default_tiers(engine: WmdEngine, prune: str,
                  nprobe: int | None = None,
                  nprobe_degraded: int | None = None,
                  refine_factor: int = 4) -> tuple[Tier, ...]:
    """The exact -> reduced-nprobe -> refine -> rwmd ladder for this
    engine/prune.

    ``nprobe`` is the TOP tier's probe count (``None`` = all = exact: a
    caller already serving approximate retrieval starts the ladder
    there); ``nprobe_degraded`` defaults to a quarter of it. Non-IVF
    prune specs have no nprobe knob, so their ladder is
    exact -> refine -> rwmd. ``refine_factor`` sizes the refine tier's
    solve budget (``refine_factor * k`` Sinkhorn-solved candidates per
    query). A sharded engine (``n_shards > 1``) gets per-shard wording and
    the reduced tier sized against its smallest shard's cluster count.
    """
    per_shard = getattr(engine, "n_shards", 1) > 1
    tiers = [Tier(
        "exact", nprobe, True,
        "exact top-k" if nprobe is None else
        f"approximate: probes {nprobe} IVF clusters per query"
        + (" per shard" if per_shard else "") + "; recall "
        "measured monotone in nprobe (fig9)")]
    is_ivf = isinstance(prune, str) and prune.startswith("ivf") \
        and _ivf_cluster_count(engine) is not None
    if is_ivf:
        c = _ivf_cluster_count(engine)
        top = nprobe if nprobe is not None else c
        red = nprobe_degraded if nprobe_degraded is not None \
            else max(1, top // 4)
        if red < top:
            tiers.append(Tier(
                "reduced_nprobe", red, True,
                f"degraded: probes {red}/{c} IVF clusters per query"
                + (" per shard" if per_shard else "") + " — "
                "approximate top-k, recall monotone in nprobe (fig9); "
                "un-probed clusters are unreachable"))
    rf = max(1, int(refine_factor))
    tiers.append(Tier(
        "refine", nprobe, True,
        f"degraded: rank-then-refine — candidates ranked by the "
        f"cascade's lower bound, only the top {rf}*k Sinkhorn-solved "
        "per query; reported distances are exact truncated-Sinkhorn "
        "scores but membership is approximate, recall measured "
        "monotone in refine_factor (fig13)",
        mode="refine", refine_factor=rf))
    tiers.append(Tier(
        "rwmd", None, False,
        "degraded: ranked by the LC-RWMD lower bound, no Sinkhorn solve "
        "— ordering approximates the exact WMD ranking and reported "
        "distances are admissible lower bounds, not WMD values"))
    return tuple(tiers)


# -------------------------------------------------------------- requests
@dataclass
class ServeRequest:
    rid: int
    query: np.ndarray
    k: int
    deadline: float | None        # absolute time.monotonic() budget
    enqueue_t: float
    v_r: int
    future: asyncio.Future = None


@dataclass
class ServeResponse:
    """One request's terminal state: a result (tagged with its serving
    tier + recall caveat) or a structured error; never an exception."""

    rid: int
    ok: bool
    tier: str | None = None
    exact: bool = False
    caveat: str | None = None
    indices: list | None = None
    distances: list | None = None
    error: dict | None = None     # {"code", "message", ["diagnostics"]}
    queue_ms: float = 0.0
    service_ms: float = 0.0
    batch_size: int = 0
    dispatch_id: int = -1
    attempts: int = 1
    deadline_missed: bool = False
    straggler: bool = False       # dispatch tripped the watchdog
    solve_iters: dict | None = None   # per-stage mean realized iterations
    iter_stats_dropped: int = 0   # engine ring discards, cumulative
    partial: bool = False         # a shard missed: result covers < 100%
    coverage: float | None = None     # covered corpus fraction if partial
    missing_shards: list | None = None  # shard ids absent from the merge
    kcache: dict | None = None    # this dispatch's cdist-row cache hits/
    #                               misses/hit_rate, when the engine
    #                               carries a cache

    def to_json(self) -> dict:
        d = {"rid": self.rid, "ok": self.ok, "tier": self.tier,
             "exact": self.exact, "queue_ms": round(self.queue_ms, 3),
             "service_ms": round(self.service_ms, 3),
             "batch_size": self.batch_size,
             "deadline_missed": self.deadline_missed}
        if self.ok:
            d["indices"] = self.indices
            d["distances"] = self.distances
            d["caveat"] = self.caveat
            if self.solve_iters:
                d["solve_iters"] = self.solve_iters
        else:
            d["error"] = self.error
        if self.straggler:
            d["straggler"] = True
        if self.iter_stats_dropped:
            d["iter_stats_dropped"] = self.iter_stats_dropped
        if self.partial:
            d["partial"] = True
            d["coverage"] = self.coverage
            d["missing_shards"] = self.missing_shards
        if self.kcache is not None:
            d["kcache"] = self.kcache
        return d


def _error_response(req: ServeRequest, code: str, message: str,
                    diagnostics: str | None = None, **kw) -> ServeResponse:
    err = {"code": code, "message": message}
    if diagnostics:
        err["diagnostics"] = diagnostics
    return ServeResponse(rid=req.rid, ok=False, error=err, **kw)


def _validate_query(q: np.ndarray) -> str | None:
    """Admission-time shape/dtype/finiteness check: the reason string for
    a structured ``invalid_query`` rejection, or ``None`` for a
    well-formed query. Runs BEFORE the request can reach the worker
    thread: a NaN histogram must not burn a dispatch and trip the
    poison-isolation path for its batchmates."""
    if q.dtype == object or not (np.issubdtype(q.dtype, np.number)
                                 or q.dtype == np.bool_):
        return (f"query must be a numeric histogram over the "
                f"vocabulary, got dtype {q.dtype}")
    if q.ndim != 1:
        return (f"query must be a 1-D vocabulary histogram, got shape "
                f"{q.shape}")
    if not np.isfinite(q).all():
        return ("query weights must be finite: NaN/Inf in the "
                "histogram (WMD marginals are undefined)")
    return None


# -------------------------------------------------------- fault injection
def _unit_draw(seed: int, *site: int) -> float:
    """Deterministic U[0,1) as a pure function of (seed, site): counter
    mode, so injection decisions are independent of call ORDER and a
    chaos run replays identically from its seed."""
    return float(np.random.default_rng((seed,) + tuple(site)).random())


class InjectedFault(RuntimeError):
    """Injected transient dispatch failure (classified retryable)."""


class ShardCrashed(RuntimeError):
    """Injected shard crash: the shard 'process' is down, so EVERY
    attempt against it fails (a RuntimeError, so a shard-level retry loop
    burns its budget and the circuit opens) until the injector's
    :meth:`FaultInjector.revive_shard` ends the outage."""


@dataclass
class FaultInjector:
    """Seeded, deterministic chaos hooks for the serving runtime.

    ``before_attempt(dispatch_id, attempt)`` runs INSIDE the guarded
    dispatch region: with probability ``latency_rate`` it sleeps
    ``latency_s`` (stage latency / straggler injection: trips the
    watchdog when it exceeds it), and with probability
    ``transient_rate`` it raises :class:`InjectedFault` on attempts
    below ``transient_attempts`` (default 1: only the first attempt can
    fault, so the retry path is exercised and recovers; raise it toward
    ``max_retries + 1`` to exercise retry exhaustion). ``poison(rid)``
    deterministically marks requests as poison: the dispatch raises
    :class:`PoisonRequest` for them, driving the per-request isolation
    path. All decisions are pure functions of ``(seed, site)``; ``trace``
    records them for the replay-determinism test.

    Shard-granular sites: ``before_shard_attempt(shard, seq, attempt)``
    runs inside a sharded engine's per-shard retry region (wired by
    :class:`ServingRuntime` when the engine exposes ``shard_fault_hook``):
    shard latency/hang (site 4), shard transients (site 5), and a
    deterministic CRASH WINDOW: ``crash_shard`` fails every attempt from
    fan-out ``crash_after`` for ``crash_for`` fan-outs (``0`` = until
    :meth:`revive_shard`).
    """

    latency_rate: float = 0.0
    latency_s: float = 0.05
    transient_rate: float = 0.0
    transient_attempts: int = 1
    poison_rate: float = 0.0
    shard_latency_rate: float = 0.0
    shard_latency_s: float = 0.05
    shard_transient_rate: float = 0.0
    shard_transient_attempts: int = 1
    crash_shard: int = -1         # shard id to crash (-1 = none)
    crash_after: int = 0          # fan-out sequence where the crash begins
    crash_for: int = 0            # crashed fan-outs (0 = until revive)
    seed: int = 0
    trace: list = field(default_factory=list)

    def poison(self, rid: int) -> bool:
        if self.poison_rate <= 0:
            return False
        hit = _unit_draw(self.seed, 3, rid) < self.poison_rate
        if hit:
            self.trace.append(("poison", rid))
        return hit

    def before_attempt(self, dispatch_id: int, attempt: int) -> None:
        if self.latency_rate > 0 and \
                _unit_draw(self.seed, 1, dispatch_id, attempt) \
                < self.latency_rate:
            self.trace.append(("latency", dispatch_id, attempt))
            time.sleep(self.latency_s)
        if self.transient_rate > 0 and attempt < self.transient_attempts \
                and _unit_draw(self.seed, 2, dispatch_id, attempt) \
                < self.transient_rate:
            self.trace.append(("transient", dispatch_id, attempt))
            raise InjectedFault(
                f"injected transient fault (dispatch {dispatch_id} "
                f"attempt {attempt})")

    def before_shard_attempt(self, shard: int, seq: int,
                             attempt: int) -> None:
        """Shard-granular chaos entry point (see class docstring); runs
        on the shard's fan-out worker thread, inside its retry loop."""
        if shard == self.crash_shard and seq >= self.crash_after and (
                self.crash_for <= 0
                or seq < self.crash_after + self.crash_for):
            self.trace.append(("shard_crash", shard, seq, attempt))
            raise ShardCrashed(
                f"injected crash: shard {shard} is down "
                f"(fan-out {seq} attempt {attempt})")
        if self.shard_latency_rate > 0 and \
                _unit_draw(self.seed, 4, shard, seq, attempt) \
                < self.shard_latency_rate:
            self.trace.append(("shard_latency", shard, seq, attempt))
            time.sleep(self.shard_latency_s)
        if self.shard_transient_rate > 0 \
                and attempt < self.shard_transient_attempts \
                and _unit_draw(self.seed, 5, shard, seq, attempt) \
                < self.shard_transient_rate:
            self.trace.append(("shard_transient", shard, seq, attempt))
            raise InjectedFault(
                f"injected shard transient (shard {shard} "
                f"fan-out {seq} attempt {attempt})")

    def revive_shard(self) -> None:
        """End the crash window (the drill's 'shard host came back')."""
        if self.crash_shard >= 0:
            self.trace.append(("shard_revive", self.crash_shard))
        self.crash_shard = -1


# ----------------------------------------------------------- degraded tier
def rwmd_topk(engine: WmdEngine, queries: Sequence, k: int):
    """LC-RWMD scoring tier: rank every doc by the doc-side relaxed-WMD
    lower bound, NO Sinkhorn solve, the cheapest rung of the ladder.

    Reuses the engine's staging (pow2 v_r buckets) and the full-sweep
    :class:`~repro_torch.core.prune.RwmdPruner`: one min-cdist (K2 on the
    card, its plain version on the CPU) + O(nnz) gather per chunk, ranked
    with ties to the lower doc, as the reference's ``lax.top_k``. Returns
    caller-order ``(indices, bounds)`` arrays shaped like
    :meth:`WmdEngine.search` output; empty queries get ``-1`` / NaN rows.
    The bound is admissible w.r.t. the computed Sinkhorn score, so
    reported values never exceed the distance the exact tiers would have
    returned. An engine with its own ``rwmd_topk`` (a sharded one) is
    delegated to.
    """
    from repro_torch.core.prune import RwmdPruner, _smallest
    if hasattr(engine, "rwmd_topk"):
        return engine.rwmd_topk(queries, k)
    queries = [np.asarray(q) for q in queries]
    n = engine.index.n_docs
    k = min(int(k), n)
    out_i = np.full((len(queries), k), -1, np.int32)
    out_d = np.full((len(queries), k), np.nan, engine.dtype)
    if not queries or n == 0 or k == 0:
        return out_i, out_d
    pruner = RwmdPruner()
    _, chunks = engine._plan(queries)
    for chunk, width in chunks:
        sup, r, mask = engine._prep_chunk([queries[qi] for qi in chunk],
                                          width)
        lb = pruner.lower_bounds(engine.index, sup, r, mask)
        d, pos = _smallest(lb[:len(chunk)], k)
        pos = pos.cpu().numpy()
        d = d.cpu().numpy()
        ext = engine._ext(pos.reshape(-1)).reshape(pos.shape)
        for ci, qi in enumerate(chunk):
            out_i[qi], out_d[qi] = ext[ci], d[ci]
    return out_i, out_d


# --------------------------------------------------------------- runtime
@dataclass
class ServeConfig:
    max_batch: int = 8            # full-dispatch trigger per v_r bucket
    window_s: float = 0.01        # deadline-dispatch trigger (oldest wait)
    max_queue: int = 64           # admission bound: queued + in flight
    deadline_s: float | None = 0.5   # default per-request budget
    degrade_depth: tuple = (0.5, 0.75, 0.9)  # queue-depth watermarks
    #                         (fracs of max_queue) for tiers 1, 2, ...
    prune: str = "ivf+wcd+rwmd"   # solve tiers' prune spec
    nprobe: int | None = None     # top tier (None = all = exact)
    nprobe_degraded: int | None = None  # tier-1 probe count (default /4)
    refine_factor: int = 4        # refine tier's solve budget multiple
    max_retries: int = 2
    backoff_s: float = 0.02
    jitter: float = 0.25
    watchdog_s: float = 5.0
    seed: int = 0
    ema_alpha: float = 0.3        # per-tier service-time EMA smoothing
    kcache_slots: int = 512       # cross-request cdist-row cache, enabled
    #                               by default in serving; 0 disables.
    #                               Bit-exact either way (core/kcache.py);
    #                               a no-op when the engine already
    #                               carries a cache or its impl can't
    #                               host one (impl="kernel")


class ServingRuntime:
    """Long-lived async serving front-end over one :class:`WmdEngine`.

    Owns the engine's iteration-stats ring (it is reset per dispatch for
    per-request attribution); dispatches are serialized on one worker
    thread (one device). See the module docstring for the full contract;
    the invariant that matters: EVERY admitted request's future resolves
    to a :class:`ServeResponse`: results and errors are data, only
    runtime bugs raise.
    """

    def __init__(self, engine: WmdEngine, config: ServeConfig | None = None,
                 injector: FaultInjector | None = None,
                 tiers: Sequence[Tier] | None = None):
        self.engine = engine
        self.cfg = config or ServeConfig()
        self.injector = injector
        self.tiers = tuple(tiers) if tiers is not None else default_tiers(
            engine, self.cfg.prune, self.cfg.nprobe,
            self.cfg.nprobe_degraded, self.cfg.refine_factor)
        self.guard = DispatchGuard(
            max_retries=self.cfg.max_retries, backoff_s=self.cfg.backoff_s,
            jitter=self.cfg.jitter, seed=self.cfg.seed,
            watchdog_s=self.cfg.watchdog_s,
            before_attempt=(injector.before_attempt if injector else None))
        self._ema = Heartbeat(ema_alpha=self.cfg.ema_alpha)
        self._queue: asyncio.Queue | None = None
        self._pool: ThreadPoolExecutor | None = None
        self._coalescer: asyncio.Task | None = None
        self._tasks: set = set()
        self._depth = 0               # queued + coalescing + in flight
        self._next_rid = 0
        self._next_dispatch = 0
        self._iters_dropped = 0       # engine ring discards, accumulated
        self._closing = False         # graceful-drain flag
        self.counters = {
            "submitted": 0, "rejected": 0, "invalid_query": 0,
            "dispatches": 0, "errors": 0,
            "isolations": 0, "deadline_missed": 0, "partial": 0,
            "shutdown_rejected": 0,
            "tiers": {t.name: 0 for t in self.tiers}}
        # wire the injector's shard-granular sites into a sharded
        # engine's fan-out (duck-typed: any engine exposing the hook)
        if injector is not None \
                and getattr(engine, "shard_fault_hook", ...) is None:
            engine.shard_fault_hook = injector.before_shard_attempt
        # cross-request K-column cache: enabled by default on any engine
        # that can host one and doesn't already (the kernel impl refuses)
        if self.cfg.kcache_slots > 0 \
                and getattr(engine, "kcache_stats", lambda: None)() is None:
            enable = getattr(engine, "enable_kcache", None)
            if enable is not None:
                enable(self.cfg.kcache_slots)

    # ------------------------------------------------------------ control
    async def start(self) -> None:
        assert self._coalescer is None, "runtime already started"
        self._queue = asyncio.Queue()
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="wmd-dispatch")
        self._coalescer = asyncio.create_task(self._coalesce_loop())

    async def stop(self) -> None:
        """Graceful shutdown: flush the coalescer, wait for in-flight
        dispatches, then tear down the worker."""
        if self._coalescer is None:
            return
        self._queue.put_nowait(None)          # flush sentinel
        await self._coalescer
        if self._tasks:     # coalescer launches before returning: snapshot
            await asyncio.gather(*list(self._tasks))
        self._pool.shutdown(wait=True)
        self._coalescer = None

    def request_shutdown(self) -> None:
        """Begin a graceful drain (SIGTERM/SIGINT handler): everything
        already admitted still coalesces, dispatches, and resolves;
        every LATER :meth:`submit` gets an immediate structured
        ``shutting_down`` rejection instead of being admitted.
        Synchronous and idempotent: safe to install directly as an
        asyncio signal handler. The teardown stays with :meth:`stop`."""
        self._closing = True

    @property
    def closing(self) -> bool:
        return self._closing

    # ------------------------------------------------------------- submit
    def submit(self, query, k: int = 10,
               deadline_s: float | None = ...) -> asyncio.Future:
        """Admit one request; returns a future resolving to a
        :class:`ServeResponse`. Admission control runs HERE: a full queue
        rejects immediately with a structured ``rejected_overload``
        response (backpressure: the caller should retry after
        ``retry_after_s``); an empty query is a structured
        ``empty_query`` error (deterministic, never dispatched).

        Exactness contract: the response's ``tier``/``exact``/``caveat``
        fields say what was served. Only the ``exact`` tier guarantees
        exact top-k; ``reduced_nprobe`` and ``refine`` return exact
        truncated-Sinkhorn distances over an approximate candidate set;
        ``rwmd`` returns admissible lower bounds, not WMD values.

        Failure modes: ``resp.ok == False`` with ``error["code"]`` one
        of (the future itself NEVER raises):

        - ``rejected_overload``: queue full, retry later (only refusal).
          ``error["retry_after_s"]`` is the measured service-time EMA of
          the tier the degradation watermarks would serve at the CURRENT
          depth.
        - ``shutting_down``: the runtime is draining after
          :meth:`request_shutdown`; this request was not admitted.
        - ``invalid_query``: not a finite 1-D numeric histogram: rejected
          at admission, never dispatched.
        - ``empty_query``: query has no support; WMD is undefined.
        - ``lam_underflow``: deterministic per-request
          :class:`LamUnderflowError`: K = exp(-lam*M) underflowed for
          this query; lower ``lam`` or build the engine with
          ``precision="log"`` (diagnostics attached).
        - ``poison``: deterministic per-request failure pinned by the
          isolation path (batchmates still get answers).
        - ``retries_exhausted``: transient dispatch faults exceeded
          ``max_retries``.
        - ``shard_failed``: every responding shard of a sharded engine
          failed this dispatch (per-shard reasons in diagnostics).
        - ``internal``: anything else, as data rather than a crash."""
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        rid = self._next_rid
        self._next_rid += 1
        self.counters["submitted"] += 1
        now = time.monotonic()
        if deadline_s is ...:
            deadline_s = self.cfg.deadline_s
        # malformed queries are structured-rejected HERE: admitted, a NaN
        # query would burn a dispatch and trip per-request isolation, and
        # a ragged/2-D one would die as `internal`
        try:
            q = np.asarray(query)
            invalid = _validate_query(q)
        except Exception as e:          # noqa: BLE001 — admission boundary
            q = np.zeros(0)
            invalid = f"query is not array-like: {type(e).__name__}: {e}"
        req = ServeRequest(
            rid=rid, query=q, k=int(k),
            deadline=None if deadline_s is None else now + deadline_s,
            enqueue_t=now,
            v_r=0 if invalid else int((q > 0).sum()), future=fut)
        if self._closing:
            self.counters["shutdown_rejected"] += 1
            fut.set_result(_error_response(
                req, "shutting_down",
                "runtime is draining for shutdown; request not admitted "
                "(already-admitted requests still resolve)"))
            return fut
        if invalid:
            self.counters["invalid_query"] += 1
            fut.set_result(_error_response(req, "invalid_query", invalid))
            return fut
        if req.v_r == 0:
            fut.set_result(_error_response(
                req, "empty_query",
                "query has no support (WMD undefined for an empty "
                "marginal)"))
            return fut
        if self._depth >= self.cfg.max_queue:
            self.counters["rejected"] += 1
            # backpressure hint from the tier the watermark logic would
            # serve RIGHT NOW (tier 0's EMA is stale under overload)
            est = self._retry_after()
            resp = _error_response(
                req, "rejected_overload",
                f"queue full ({self.cfg.max_queue}); backpressure — "
                f"retry after ~{round(est + self.cfg.window_s, 4)}s")
            resp.error["retry_after_s"] = round(est + self.cfg.window_s, 4)
            fut.set_result(resp)
            return fut
        self._depth += 1
        self._queue.put_nowait(req)
        return fut

    # --------------------------------------------------------- coalescing
    async def _coalesce_loop(self) -> None:
        """Deadline-or-full micro-batching, grouped by pow2 v_r bucket.

        A bucket dispatches the moment it holds ``max_batch`` requests
        (FULL) or when its OLDEST member has waited ``window_s``
        (DEADLINE: latency is bounded even at low offered load). Distinct
        buckets never share a dispatch: one dispatch is one chunk
        shape."""
        pending: dict[int, list[ServeRequest]] = {}
        flush = False
        while True:
            timeout = None
            if pending:
                now = time.monotonic()
                timeout = max(0.0, min(
                    reqs[0].enqueue_t + self.cfg.window_s - now
                    for reqs in pending.values()))
            try:
                req = await asyncio.wait_for(self._queue.get(), timeout)
                if req is None:
                    flush = True
                else:
                    b = bucket_size(req.v_r, self.engine.min_bucket)
                    pending.setdefault(b, []).append(req)
                    if len(pending[b]) >= self.cfg.max_batch:
                        self._launch(pending.pop(b))
            except asyncio.TimeoutError:
                pass
            now = time.monotonic()
            for b in list(pending):
                if flush or (pending[b][0].enqueue_t + self.cfg.window_s
                             <= now):
                    self._launch(pending.pop(b))
            if flush and not pending:
                return

    def _launch(self, batch: list[ServeRequest]) -> None:
        tier_i = self._choose_tier(batch, time.monotonic())
        task = asyncio.create_task(self._run_dispatch(batch, tier_i))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    # ------------------------------------------------------ tier selection
    def _choose_tier(self, batch: list[ServeRequest], now: float) -> int:
        """Degrade-don't-drop policy, applied per coalesced dispatch:

        - queue depth over a ``degrade_depth`` watermark forces at least
          that many rungs down (load shedding into cheaper tiers);
        - the batch's TIGHTEST remaining deadline budget must afford the
          chosen tier's measured service-time EMA, else fall further;
        - an already-blown budget serves the cheapest tier: a degraded
          answer now beats an exact answer nobody is waiting for.
        """
        last = len(self.tiers) - 1
        tier = self._depth_tier()
        budgets = [r.deadline - now for r in batch
                   if r.deadline is not None]
        if budgets:
            b = min(budgets)
            if b <= 0:
                return last
            while tier < last:
                est = self._ema.ema(tier)
                if est is None or est <= b:
                    break
                tier += 1
        return tier

    def _depth_tier(self) -> int:
        """Tier the queue-depth watermarks force at the CURRENT depth:
        the load-shedding half of :meth:`_choose_tier`, shared with the
        backpressure hint so both report the same ladder position."""
        last = len(self.tiers) - 1
        tier = 0
        for i, frac in enumerate(self.cfg.degrade_depth, start=1):
            if self._depth >= frac * self.cfg.max_queue:
                tier = min(i, last)
        return tier

    def _retry_after(self) -> float:
        """Backpressure hint: the service-time EMA of the tier the
        watermark logic would serve right now, falling back across the
        ladder (cheaper tiers first, whose EMAs are fresh under
        overload) and then back up toward exact; 0 before any dispatch
        has been measured."""
        t = self._depth_tier()
        for i in list(range(t, len(self.tiers))) + list(range(t - 1, -1, -1)):
            est = self._ema.ema(i)
            if est is not None:
                return est
        return 0.0

    # ----------------------------------------------------------- dispatch
    async def _run_dispatch(self, batch: list[ServeRequest],
                            tier_i: int) -> None:
        loop = asyncio.get_running_loop()
        results = await loop.run_in_executor(
            self._pool, self._dispatch, batch, tier_i)
        for req in batch:
            resp = results[req.rid]
            self.counters["errors"] += 0 if resp.ok else 1
            if resp.deadline_missed:
                self.counters["deadline_missed"] += 1
            if resp.ok:
                self.counters["tiers"][resp.tier] += 1
                if resp.partial:
                    self.counters["partial"] += 1
            self._depth -= 1
            if not req.future.done():
                req.future.set_result(resp)

    def _dispatch(self, batch: list[ServeRequest], tier_i: int) -> dict:
        """Worker-thread body: guarded solve with per-request isolation.

        Never raises: every request maps to a response. The first
        deterministic failure (injected poison, lam underflow) switches
        to one-request-at-a-time isolation so the poison is pinned to its
        request and batchmates still get answers; transient failures
        retry inside the guard and exhaust into structured errors."""
        did = self._next_dispatch
        self._next_dispatch += 1
        self.counters["dispatches"] += 1
        t0 = time.monotonic()
        trips0 = self.guard.watchdog_trips
        try:
            results = self._guarded_solve(batch, tier_i, did)
        except (PoisonStep, FloatingPointError):
            self.counters["isolations"] += 1
            results = {}
            for req in batch:
                try:
                    results.update(self._guarded_solve([req], tier_i, did))
                except Exception as e:          # noqa: BLE001 — boundary
                    results[req.rid] = self._classify_error(req, e)
        except Exception as e:                  # noqa: BLE001 — boundary
            results = {req.rid: self._classify_error(req, e)
                       for req in batch}
        dt = time.monotonic() - t0
        if any(results[r.rid].ok for r in batch):
            self._ema.record(tier_i, dt)
        straggler = self.guard.watchdog_trips > trips0
        now = time.monotonic()
        for req in batch:
            resp = results[req.rid]
            resp.queue_ms = (t0 - req.enqueue_t) * 1e3
            resp.service_ms = dt * 1e3
            resp.batch_size = len(batch)
            resp.dispatch_id = did
            resp.straggler = straggler
            resp.deadline_missed = (req.deadline is not None
                                    and now > req.deadline)
            resp.iter_stats_dropped = self._iters_dropped
        return results

    def _guarded_solve(self, reqs: list[ServeRequest], tier_i: int,
                       did: int) -> dict:
        tier = self.tiers[tier_i]

        def body():
            if self.injector is not None:
                for req in reqs:
                    if self.injector.poison(req.rid):
                        raise PoisonRequest(
                            req.rid, f"injected poison request "
                            f"(rid {req.rid})")
            return self._score(reqs, tier)

        try:
            return self.guard.run(body, tag=did)
        except PoisonRequest as e:
            if len(reqs) == 1:          # isolated: pin it to the request
                return {reqs[0].rid: _error_response(
                    reqs[0], "poison", str(e))}
            raise                        # batch path: isolate upstream

    def _classify_error(self, req: ServeRequest, e: Exception) \
            -> ServeResponse:
        """Exception -> structured error response (the server's last
        line: anything reaching here is data, not a crash)."""
        if isinstance(e, LamUnderflowError):
            return _error_response(
                req, "lam_underflow",
                "deterministic per-request failure: K = exp(-lam*M) "
                "underflowed for this query's support; lower lam or use "
                "precision='log'", diagnostics=str(e))
        if isinstance(e, PoisonStep):
            return _error_response(req, "poison", str(e))
        if isinstance(e, DispatchFailed):
            return _error_response(req, "retries_exhausted", str(e))
        if isinstance(e, ShardSearchError):
            return _error_response(
                req, "shard_failed",
                "sharded fan-out failed on every responding shard "
                "(shard-level retries already exhausted; not retried "
                "upstream)", diagnostics=str(e))
        return _error_response(req, "internal",
                               f"{type(e).__name__}: {e}")

    def _score(self, reqs: list[ServeRequest], tier: Tier) -> dict:
        """One engine call for a coalesced batch at one tier; slices the
        per-request rows out and attaches per-dispatch observability
        (realized solve iterations by stage, ring-drop counter)."""
        queries = [r.query for r in reqs]
        kmax = max(r.k for r in reqs)
        self._iters_dropped += self.engine.iter_stats_dropped
        self.engine.reset_iter_stats()    # per-dispatch attribution
        kc0 = getattr(self.engine, "kcache_stats", lambda: None)()
        if tier.solve:
            kw = {}
            if tier.mode != "exact":
                kw = {"mode": tier.mode,
                      "refine_factor": tier.refine_factor or 4}
            res = self.engine.search(queries, kmax, prune=self.cfg.prune,
                                     nprobe=tier.nprobe, **kw)
            indices, dists = res.indices, res.distances
        else:
            indices, dists = rwmd_topk(self.engine, queries, kmax)
        # coverage accounting: a sharded engine reports how much of the
        # corpus this call touched. Race-free: dispatches are serialized
        # on ONE worker thread, so the attribute pairs with this search.
        cov = getattr(self.engine, "last_coverage", None)
        partial = bool(cov is not None and cov.missing_shards)
        caveat = tier.caveat
        if partial:
            detail = ", ".join(f"{s}: {r}" for s, r
                               in sorted(cov.reasons.items()))
            caveat = (
                f"{caveat}; PARTIAL: shard(s) "
                f"{list(cov.missing_shards)} missing ({detail}) — "
                f"covers {cov.fraction:.2%} of the corpus; recall vs "
                f"the full corpus is bounded above by that fraction")
        iters = {st: round(float(arr.mean()), 2)
                 for st, arr in self.engine.iter_stats_by_stage().items()
                 if arr.size}
        # this dispatch's delta of the cross-request cache's counters
        # (race-free for the same single-worker-thread reason)
        kc = None
        kc1 = getattr(self.engine, "kcache_stats", lambda: None)()
        if kc1 is not None:
            dh = kc1["hits"] - (kc0["hits"] if kc0 else 0)
            dm = kc1["misses"] - (kc0["misses"] if kc0 else 0)
            kc = {"hits": dh, "misses": dm,
                  "hit_rate": round(dh / (dh + dm), 4) if dh + dm else 0.0}
        out = {}
        for i, req in enumerate(reqs):
            kk = min(req.k, indices.shape[1])
            out[req.rid] = ServeResponse(
                rid=req.rid, ok=True, tier=tier.name,
                # a partial result must NEVER claim exactness, whatever
                # the tier says: coverage < 1 caps recall below 1
                exact=(tier.solve and tier.nprobe is None
                       and tier.mode == "exact" and not partial),
                caveat=caveat,
                indices=np.asarray(indices[i][:kk]).tolist(),
                distances=[round(float(v), 6)
                           for v in np.asarray(dists[i][:kk])],
                solve_iters=iters or None,
                partial=partial,
                coverage=(round(float(cov.fraction), 4) if partial
                          else None),
                missing_shards=(list(cov.missing_shards) if partial
                                else None),
                kcache=kc)
        return out

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Runtime-level counters for the serve JSON / load generator."""
        c = dict(self.counters)
        c["tiers"] = dict(self.counters["tiers"])
        total = sum(c["tiers"].values())
        degraded = total - c["tiers"].get(self.tiers[0].name, 0)
        c["degraded_frac"] = round(degraded / total, 4) if total else 0.0
        c["retries"] = self.guard.retries
        c["watchdog_trips"] = self.guard.watchdog_trips
        c["iter_stats_dropped"] = (self._iters_dropped
                                   + self.engine.iter_stats_dropped)
        c["tier_ema_s"] = {self.tiers[i].name: round(v, 4)
                           for i, v in self._ema._ema.items()}
        kc = getattr(self.engine, "kcache_stats", lambda: None)()
        if kc is not None:
            c["kcache"] = kc
        shards = getattr(self.engine, "n_shards", None)
        if shards:
            c["shards"] = int(shards)
            c["docs_per_shard"] = [int(n) for n in
                                   self.engine.docs_per_shard]
        health = getattr(self.engine, "health", None)
        if health is not None:
            c["shard_health"] = health.stats()
        return c


# ------------------------------------------------------------ load driving
def poisson_arrivals(n: int, rate_per_s: float, seed: int = 0) -> np.ndarray:
    """Open-loop arrival offsets (seconds): exponential inter-arrivals at
    ``rate_per_s``, deterministic in ``seed``."""
    rng = np.random.default_rng((seed, zlib.crc32(b"arrivals")))
    return np.cumsum(rng.exponential(1.0 / rate_per_s, size=n))


def run_open_loop(runtime: ServingRuntime, queries: Sequence,
                  arrivals_s: Sequence[float], k: int = 10,
                  deadline_s: float | None = ...,
                  handle_signals: bool = False):
    """Drive the runtime open-loop: request ``i`` is submitted at offset
    ``arrivals_s[i]`` REGARDLESS of completions (offered load is the
    independent variable: queueing delay shows up in the latency tail).
    Returns ``(responses, stats)`` with responses in submission order;
    every submission resolves (result or structured error): an unhandled
    exception here is a runtime bug.

    ``handle_signals=True`` installs SIGTERM/SIGINT handlers that call
    :meth:`ServingRuntime.request_shutdown` (graceful drain): the
    remaining arrivals submit immediately and resolve as structured
    ``shutting_down`` rejections, already-admitted requests dispatch
    and resolve normally, and the function still returns ``(responses,
    stats)``. No-op on platforms without ``loop.add_signal_handler``."""
    async def _go():
        await runtime.start()
        loop = asyncio.get_running_loop()
        installed = []
        if handle_signals:
            import signal as _signal
            for sig in (_signal.SIGINT, _signal.SIGTERM):
                try:
                    loop.add_signal_handler(sig, runtime.request_shutdown)
                    installed.append(sig)
                except (NotImplementedError, RuntimeError):
                    pass
        try:
            t0 = time.monotonic()
            futs = []
            for q, at in zip(queries, arrivals_s):
                if not runtime.closing:
                    delay = t0 + float(at) - time.monotonic()
                    if delay > 0:
                        await asyncio.sleep(delay)
                futs.append(runtime.submit(q, k=k, deadline_s=deadline_s))
            out = await asyncio.gather(*futs)
            await runtime.stop()
        finally:
            for sig in installed:
                loop.remove_signal_handler(sig)
        return list(out), runtime.stats()
    return asyncio.run(_go())
