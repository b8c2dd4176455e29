"""Wrappers around the port's Hopper kernels, and the single-query kernel
path :func:`sinkhorn_wmd_kernel` built from them.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with torch (the kernels allocate nothing), launches on its
tensors' device (made the calling thread's current device for the launch:
the sharded engine launches from pool threads, possibly for shards on
different cards) and that device's current stream, raises if the launch
failed, and adds one to its ``launches`` counter for each kernel launch
(one per call; three for K1 past 64 x 64: its live-tile kernel's two size
classes and the stream kernel; ``bsr_sddmm`` counts its launch under
``bsr_sddmm_blocks``). The
library load and the counters are safe under threads. A tensor on the CPU
goes to the plain version in :mod:`.ref` instead (and does not count); a
CUDA tensor always launches the kernel — there is no fallback.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import ref

# per-block dynamic shared memory limit of the H100 (227 KB)
MAX_SMEM_BYTES = 232_448
# K1's live-tile kernel: the shared memory its block packs pairs into (the
# rest of the 227 KB holds its round's bookkeeping); a pair whose live
# tile needs more (live_tile_bytes) is streamed from device memory
LIVE_ARENA_BYTES = 228_352
# the live-tile kernel's reduction runs (kLSeg in sinkhorn_fused.cu)
_LIVE_SEG = 64
# queries a block of the stacked K2 serves (kStMaxQ in rwmd_min_cdist.cu);
# more queries take more blocks of the same launch
RWMD_STACKED_MAX_Q = 64

_LIB = None
_LIB_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def _lib():
    """The kernels' library, built and loaded once per process; threads
    that ask while it is being built wait for it."""
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                from .build import load
                _LIB = load()
    return _LIB


def _count(fn, n: int = 1) -> None:
    with _COUNT_LOCK:
        fn.launches += n


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check(name: str, t: torch.Tensor, ndim: int, dtype, device) -> None:
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _launch(dev: torch.device, name: str, entry, *args) -> None:
    """Call the C entry point with ``dev`` as the calling thread's current
    device (a ctypes launch goes to the current device, and its
    per-device attribute caches are keyed by it) on ``dev``'s current
    stream; raise if the launch failed."""
    with torch.cuda.device(dev):
        _raise_on(entry(*args, _stream(dev)), name)


def _rwmd_checks(a, mask, b) -> None:
    dev = a.device
    for name, t, nd in (("a", a, 3), ("mask", mask, 2), ("b", b, 2)):
        _check(name, t, nd, torch.float32, dev)
    q, bq, w = a.shape
    if mask.shape != (q, bq) or b.shape[1] != w:
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, mask "
                         f"{tuple(mask.shape)}, b {tuple(b.shape)}")
    if dev.type != "cpu" and bq < 1:
        raise ValueError("rwmd_min_cdist needs at least one support row")


def rwmd_min_cdist(a: torch.Tensor, mask: torch.Tensor, b: torch.Tensor,
                   vocab_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Masked min-over-support cdist (the RWMD prune stage).
    a (Q, B, w), mask (Q, B), b (V, w) -> minM (Q, V); all-masked rows
    come out +inf. On the card one launch at any Q: a block per
    (vocabulary tile, RWMD_STACKED_MAX_Q queries) serves every live row of
    its queries, so b is read once per RWMD_STACKED_MAX_Q queries.

    ``vocab_ids`` (Vc,) int64 switches to K2s
    (:func:`rwmd_min_cdist_subset`): only those rows of b, and the result
    is (Q, Vc) in ``vocab_ids`` order."""
    if vocab_ids is not None:
        return rwmd_min_cdist_subset(a, mask, b, vocab_ids)
    _rwmd_checks(a, mask, b)
    q, bq, w = a.shape
    dev = a.device
    if dev.type == "cpu":
        return ref.rwmd_min_cdist_ref(a, mask, b)
    v = b.shape[0]
    out = torch.empty((q, v), dtype=torch.float32, device=dev)
    _launch(dev, "rwmd_min_cdist", _lib().rwmd_min_cdist_launch,
            _ptr(a), _ptr(mask), _ptr(b), _ptr(out), q, bq, w, v)
    if q and v:
        _count(rwmd_min_cdist)
    return out


rwmd_min_cdist.launches = 0


def rwmd_min_cdist_subset(a: torch.Tensor, mask: torch.Tensor,
                          b: torch.Tensor,
                          vocab_ids: torch.Tensor) -> torch.Tensor:
    """K2s, the cascade's candidate-vocabulary min-cdist: K2 over the rows
    ``b[vocab_ids]`` only. a (Q, B, w), mask (Q, B), b (V, w), vocab_ids
    (Vc,) int64 with every id in [0, V) -> (Q, Vc) in ``vocab_ids`` order.
    The kernel gathers the rows in its load; no (Vc, w) copy is made. Vc
    needs no padding. One launch at any B and Vc (at most 65535 queries):
    wide Vc takes K2's stacked kernel over the gathered rows, narrow Vc a
    block per (query, 32 columns); rwmd_min_cdist.cu's subset_stacked()
    picks.
    On the CPU an id outside [0, V) raises ``ValueError``; the card does
    not check them (that would cost a sync per launch), so a caller on the
    card checks its ids on the host, as the cascade does."""
    _rwmd_checks(a, mask, b)
    dev = a.device
    _check("vocab_ids", vocab_ids, 1, torch.int64, dev)
    if dev.type == "cpu":
        if vocab_ids.numel() and (int(vocab_ids.min()) < 0
                                  or int(vocab_ids.max()) >= b.shape[0]):
            raise ValueError(f"vocab_ids must lie in [0, {b.shape[0]})")
        return ref.rwmd_min_cdist_subset_ref(a, mask, b, vocab_ids)
    q, bq, w = a.shape
    vc = vocab_ids.shape[0]
    out = torch.empty((q, vc), dtype=torch.float32, device=dev)
    _launch(dev, "rwmd_min_cdist_subset",
            _lib().rwmd_min_cdist_subset_launch, _ptr(a), _ptr(mask),
            _ptr(b), _ptr(vocab_ids), _ptr(out), q, bq, w, b.shape[0], vc)
    if q and vc:
        _count(rwmd_min_cdist_subset)
    return out


rwmd_min_cdist_subset.launches = 0


def rwmd_subset_route(q: int, b: int, vc: int) -> str:
    """The kernel a K2s call of q queries of b support rows against vc
    candidate words launches on the card: ``"stacked"`` (K2's kernel over
    the gathered rows) or ``"per_query"`` (a block per query and 32
    columns). Asked of the built library's routing rule."""
    return ("stacked" if _lib().rwmd_min_cdist_subset_stacked(q, b, vc)
            else "per_query")


def cdist_exp(a: torch.Tensor, b: torch.Tensor, r: torch.Tensor,
              lam: float, k_only: bool = False, gemm: str = "fp32",
              log_k: bool = False):
    """Fused distance, kernel and scaled kernel (K3). a (v_r, w) query
    word embeddings, b (V, w) vocabulary, r (v_r,) query weights ->
    (M, K, K/r), each (v_r, V); ``k_only`` returns K alone and writes
    nothing else. ``log_k`` makes K the unexponentiated ``-lam*M``.
    ``gemm="bf16"`` rounds the operands of the a.b product to bf16
    (products and sums fp32; the norms |a|^2 and |b|^2 stay fp32)."""
    bf16 = ref.operand_dtype(gemm) is not None
    dev = a.device
    _check("a", a, 2, torch.float32, dev)
    _check("b", b, 2, torch.float32, dev)
    _check("r", r, 1, torch.float32, dev)
    v_r, w = a.shape
    v = b.shape[0]
    if b.shape[1] != w or r.shape != (v_r,):
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, r {tuple(r.shape)}")
    if dev.type == "cpu":
        return ref.cdist_exp_ref(a, b, r, lam, k_only=k_only, log_k=log_k,
                                 gemm=gemm)
    k = torch.empty((v_r, v), dtype=torch.float32, device=dev)
    m = kr = None
    if not k_only:
        m, kr = torch.empty_like(k), torch.empty_like(k)
    null = ctypes.c_void_p(None)
    _launch(dev, "cdist_exp", _lib().cdist_exp_launch,
            _ptr(a), _ptr(b), _ptr(r), null if k_only else _ptr(m), _ptr(k),
            null if k_only else _ptr(kr), v_r, w, v,
            ctypes.c_float(float(lam)), int(log_k), int(bf16))
    _count(cdist_exp)
    return k if k_only else (m, k, kr)


cdist_exp.launches = 0


def sddmm_spmm_step(g: torch.Tensor, g_over_r: torch.Tensor,
                    val: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One fused SDDMM_SpMM Sinkhorn iteration (K5, the paper's Fig. 4
    kernel): g and g_over_r (v_r, N, L), val (N, L), x (v_r, N) -> x'
    (v_r, N), with u = 1/x and w = val/t both guarded (0 where the
    denominator is not positive)."""
    dev = g.device
    for name, t, nd in (("g", g, 3), ("g_over_r", g_over_r, 3),
                        ("val", val, 2), ("x", x, 2)):
        _check(name, t, nd, torch.float32, dev)
    v_r, n, length = g.shape
    if (g_over_r.shape != g.shape or val.shape != (n, length)
            or x.shape != (v_r, n)):
        raise ValueError(f"shape mismatch: g {tuple(g.shape)}, g_over_r "
                         f"{tuple(g_over_r.shape)}, val {tuple(val.shape)}, "
                         f"x {tuple(x.shape)}")
    if dev.type == "cpu":
        return ref.sddmm_spmm_step_ref(g, g_over_r, val, x)
    lib = _lib()
    if lib.sddmm_spmm_step_smem_bytes(length) < 0:
        raise ValueError(f"sddmm_spmm_step keeps each warp's w (L floats) "
                         f"in shared memory: L={length} needs "
                         f"{4 * length} B, the limit is {MAX_SMEM_BYTES}")
    out = torch.empty((v_r, n), dtype=torch.float32, device=dev)
    _launch(dev, "sddmm_spmm_step", lib.sddmm_spmm_step_launch,
            _ptr(g), _ptr(g_over_r), _ptr(val), _ptr(x), _ptr(out), v_r, n,
            length)
    _count(sddmm_spmm_step)
    return out


sddmm_spmm_step.launches = 0


def fits_warp(v_r: int, length: int) -> bool:
    """Does K1's ``tile="auto"`` run a (v_r, L) tile on the warp-per-tile
    kernel (up to 64 x 64)? Past it, ``auto`` runs the live-tile one."""
    return v_r <= 64 and length <= 64


def live_tile_bytes(k, length):
    """Shared memory the live-tile kernel takes for a (query, doc) pair of
    ``k`` live rows and ``length`` live slots (``live_floats`` in
    ``csrc/sinkhorn_fused.cu``): the tile at an odd row stride, the
    reductions' partial sums, and its vectors. A pair is solved in shared
    memory where this is at most :data:`LIVE_ARENA_BYTES`, else streamed
    from device memory. Integers, or integer arrays (elementwise)."""
    k, length = np.asarray(k, np.int64), np.asarray(length, np.int64)

    def r4(x):
        return (x + 3) & ~3

    ck, cl = -(-k // _LIVE_SEG), -(-length // _LIVE_SEG)
    out = 4 * (r4(k * (length | 1)) + r4(np.maximum(ck * length, cl * k))
               + 2 * r4(k) + 4 * r4(length))
    return out if out.ndim else int(out)


def _solver_smem(lib, v_r: int, length: int, variant: int, name: str) -> None:
    """Refuse a variant whose shared memory exceeds the per-block limit:
    the shared-memory one asked for by name on a tile over 227 KB (``auto``
    takes the live-tile variant there), or a tile so wide that the
    live-tile kernel's vectors of one streamed pair do not fit."""
    smem = lib.sinkhorn_fused_smem_bytes(v_r, length, variant,
                                         LIVE_ARENA_BYTES)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{name}: v_r={v_r}, L={length} needs {smem} B of shared memory "
            f"in the variant asked for, the limit is {MAX_SMEM_BYTES}")


def _solver_options(tol, check_every: int, gemm: str, resmask, shape,
                    dev):
    """Check the solvers' options: -> (resmask as a contiguous fp32
    tensor of ``shape`` on ``dev``, or None without ``tol``)."""
    ref.operand_dtype(gemm)
    if tol is None:
        return None                     # resmask only scopes the exit
    if not 1 <= int(check_every) < 2 ** 30:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if resmask is None:
        return None
    rm = torch.as_tensor(resmask, device=dev)
    if tuple(rm.shape) != tuple(shape):
        raise ValueError(f"resmask must have shape {tuple(shape)}, got "
                         f"{tuple(rm.shape)}")
    return rm.to(torch.float32).contiguous()


def _solve_launch(fn, g, val, r, rm, lam, n_iter, block_n, tol,
                  check_every, gemm, log_domain, tile, q, v_r, n, length,
                  with_iters: bool, stats=None):
    """Launch K1's kernels (K4 is the Q = 1 case) -> (wmd (q, n), iters
    (q, ceil(n / block_n)) or None without ``with_iters``). iters starts
    at 0: every doc folds its realized count into its block's entry with
    atomicMax. The live-tile route (``"auto"`` past 64 x 64) is three
    launches: the live-tile kernel's two size classes, each taking its
    pairs from a counter that starts at 0, then the stream kernel for the
    pairs over the arena, which the second lists and counts (the three
    ints after iters in one zeroed buffer: one fill for all). The first
    measures each pair's live extents, which the others read (an int a
    pair, and an int a pair for the list, in a buffer of their own, which
    no caller keeps: iters outlives the call in the engine). ``stats``, a
    zeroed (2,) int64 tensor, gathers the route's live cells solved in
    shared memory and streamed."""
    lib = _lib()
    _solver_smem(lib, v_r, length, _TILES[tile], fn.__name__)
    dev = g.device
    wmd = torch.empty((q, n), dtype=torch.float32, device=dev)
    live = tile == "auto" and not fits_warp(v_r, length)
    iters = work = ext = None
    if with_iters or live:
        nb = -(-n // block_n) if with_iters else 0
        buf = torch.zeros(q * nb + 3 * live, dtype=torch.int32, device=dev)
        if with_iters:
            iters = buf[:q * nb].view(q, nb)
        if live:
            work = buf[q * nb:]
            ext = torch.empty(2 * q * n, dtype=torch.int32, device=dev)
    null = ctypes.c_void_p(None)
    _launch(dev, fn.__name__, lib.sinkhorn_fused_batched_launch,
            _ptr(g), _ptr(val), _ptr(r), null if rm is None else _ptr(rm),
            _ptr(wmd), null if iters is None else _ptr(iters),
            null if work is None else _ptr(work),
            null if ext is None else _ptr(ext),
            null if stats is None else _ptr(stats), q, v_r, n,
            length, int(n_iter), ctypes.c_float(float(lam)), int(log_domain),
            int(block_n),
            ctypes.c_float(0.0 if tol is None else float(tol)),
            0 if tol is None else int(check_every), int(gemm == "bf16"),
            _TILES[tile], LIVE_ARENA_BYTES)
    _count(fn, 3 if live else 1)
    return wmd, iters


def sinkhorn_fused_all(g: torch.Tensor, val: torch.Tensor, r: torch.Tensor,
                       lam: float, n_iter: int, block_n: int = 128,
                       tol=None, check_every: int = 4, gemm: str = "fp32",
                       log_domain: bool = False, resmask=None,
                       with_iters: bool = False):
    """Fused Sinkhorn solve for one query (K4, K1 with Q = 1). g (v_r, N,
    L) gathered K (log K under ``log_domain``; pad rows 0, or -inf under
    ``log_domain``), val (N, L), r (v_r,) with pad rows 1 -> wmd (N,) and,
    with ``with_iters``, iters (ceil(N / block_n),), each block's largest
    realized count. ``tol``, ``check_every``, ``resmask`` (N,) and
    ``gemm`` as in :func:`sinkhorn_fused_all_batched`."""
    dev = g.device
    _check("g", g, 3, torch.float32, dev)
    _check("val", val, 2, torch.float32, dev)
    _check("r", r, 1, torch.float32, dev)
    v_r, n, length = g.shape
    if val.shape != (n, length) or r.shape != (v_r,):
        raise ValueError(f"shape mismatch: g {tuple(g.shape)}, val "
                         f"{tuple(val.shape)}, r {tuple(r.shape)}")
    if block_n < 1 or not 0 <= n_iter < 2 ** 30:
        raise ValueError(f"block_n must be positive and n_iter in [0, "
                         f"2**30), got {block_n}, {n_iter}")
    rm = _solver_options(tol, check_every, gemm, resmask, (n,), dev)
    if dev.type == "cpu":
        wmd, iters = ref.sinkhorn_fused_all_ref(
            g, val, r, lam, n_iter, log_domain=log_domain, block_n=block_n,
            tol=tol, check_every=check_every, resmask=rm, gemm=gemm)
        return (wmd, iters) if with_iters else wmd
    wmd, iters = _solve_launch(
        sinkhorn_fused_all, g, val, r, rm, lam, n_iter, block_n, tol,
        check_every, gemm, log_domain, "auto", 1, v_r, n, length,
        with_iters)
    return (wmd[0], iters[0]) if with_iters else wmd[0]


sinkhorn_fused_all.launches = 0


def sinkhorn_fused_all_batched(g: torch.Tensor, val: torch.Tensor,
                               r: torch.Tensor, lam: float, n_iter: int,
                               block_n: int = 128, tol=None,
                               check_every: int = 4, gemm: str = "fp32",
                               log_domain: bool = False, resmask=None,
                               with_iters: bool = False,
                               tile: str = "auto"):
    """Batched fused Sinkhorn solve. g (Q, v_r, N, L) gathered K (log K
    under ``log_domain``; pad query rows 0, or -inf under
    ``log_domain``), val (N, L), r (Q, v_r) with pad rows 1 -> wmd (Q, N)
    and, with ``with_iters``, iters (Q, ceil(N / block_n)): each block of
    ``block_n`` docs' largest realized count (``block_n`` only shapes
    ``iters``; the distances do not depend on it).

    ``tol`` switches from the fixed ``n_iter`` loop to the adaptive one,
    with the exit per document (:func:`.ref.sinkhorn_fused_all_batched_ref`
    gives the arithmetic): one seeded iteration, then a residual check
    every ``check_every``; ``n_iter`` is the cap. ``resmask`` (Q, N, any
    dtype, > 0 = in scope) narrows each query's exit test to its own
    candidate docs; a pad doc must be outside every scope (0), and a doc
    with an empty scope stops at the first check. It is ignored without
    ``tol``. ``gemm="bf16"`` rounds the operands of both reductions to
    bf16, with fp32 products and sums.

    ``tile`` picks the kernel's variant on the card: ``"auto"`` (what the
    engine always passes), ``"warp"`` (one warp per (query, doc) tile,
    asynchronous tile loads, inert docs skipped, up to 64 x 64;
    ``"registers"`` is an alias of it, the name of the block-per-tile
    design it replaced), ``"shared"`` (the padded tile in shared memory,
    up to the per-block limit) or ``"global"`` (the padded tile read from
    device memory at every pass, any size). ``"auto"`` runs the warp
    variant where the tile fits 64 x 64, and past it the live-tile route:
    each pair solved over its live tile only, its rows up to its last
    live row and its slots up to its last ``val != 0``, read once into
    shared memory, pairs of varied size packed into persistent blocks, in
    two launches by live size; a pair whose live tile needs more than
    :data:`LIVE_ARENA_BYTES`, by :func:`live_tile_bytes`, is streamed
    from device memory by a third; any size. Past 64 x 64 a group's and a
    chunk's padding leave most of a tile dead, which only the live route
    skips; on small tiles with little padding (~96 rows, at most 64
    slots) the shared variant is faster (PERF.md). All compute the same
    function; ``"shared"`` and ``"global"`` let tests and
    ``chip_smoke.py`` hold and time the variants against each other at
    one shape.
    """
    dev = g.device
    _check("g", g, 4, torch.float32, dev)
    _check("val", val, 2, torch.float32, dev)
    _check("r", r, 2, torch.float32, dev)
    q, v_r, n, length = g.shape
    if val.shape != (n, length) or r.shape != (q, v_r):
        raise ValueError(f"shape mismatch: g {tuple(g.shape)}, val "
                         f"{tuple(val.shape)}, r {tuple(r.shape)}")
    if block_n < 1 or not 0 <= n_iter < 2 ** 30:
        raise ValueError(f"block_n must be positive and n_iter in [0, "
                         f"2**30), got {block_n}, {n_iter}")
    if tile not in _TILES:
        raise ValueError(f"tile must be one of {sorted(_TILES)}, got "
                         f"{tile!r}")
    if tile in ("registers", "warp") and max(v_r, length) > 64:
        raise ValueError(f"tile={tile!r} holds at most 64 x 64, got "
                         f"v_r={v_r}, L={length}")
    rm = _solver_options(tol, check_every, gemm, resmask, (q, n), dev)
    if dev.type == "cpu":
        wmd, iters = ref.sinkhorn_fused_all_batched_ref(
            g, val, r, lam, n_iter, log_domain=log_domain, block_n=block_n,
            tol=tol, check_every=check_every, resmask=rm, gemm=gemm)
        return (wmd, iters) if with_iters else wmd
    if q * n >= 2 ** 30:
        raise ValueError(f"Q * N must be below 2**30, got {q} * {n}")
    wmd, iters = _solve_launch(
        sinkhorn_fused_all_batched, g, val, r, rm, lam, n_iter, block_n,
        tol, check_every, gemm, log_domain, tile, q, v_r, n, length,
        with_iters)
    return (wmd, iters) if with_iters else wmd


sinkhorn_fused_all_batched.launches = 0
_TILES = {"auto": 0, "warp": 1, "registers": 1, "shared": 2, "global": 3}


def sinkhorn_wmd_kernel(r: torch.Tensor, vecs_sel: torch.Tensor,
                        vecs: torch.Tensor, docs, lam: float, n_iter: int,
                        tol=None, check_every: int = 4,
                        precision=None) -> torch.Tensor:
    """The single-query kernel path: K3 (``cdist_exp``, K only) ->
    ``torch.index_select`` gather of each doc's K columns -> K4
    (``sinkhorn_fused_all``) -> wmd (N,). ``docs`` holds (N, L) ``idx`` and
    ``val`` tensors on ``vecs``' device. GM is rebuilt from G inside K4,
    so only one (v_r, N, L) array is materialized.

    ``precision`` (a ``SolvePrecision`` or its spelling) plumbs the bf16
    operands and the log domain through both kernels: under the log
    domain K3 emits unexponentiated log K, so no column can underflow at
    any ``lam``. ``tol``/``check_every`` select K4's adaptive loop."""
    from repro_torch.core.sinkhorn_sparse import SolvePrecision, gather_columns
    precision = SolvePrecision.parse(precision)
    k = cdist_exp(vecs_sel, vecs, r, lam, k_only=True, gemm=precision.gemm,
                  log_k=precision.log_domain)
    g = gather_columns(k, docs.idx)
    return sinkhorn_fused_all(g, docs.val, r, lam, n_iter, tol=tol,
                              check_every=check_every, gemm=precision.gemm,
                              log_domain=precision.log_domain)


def bsr_sddmm_blocks(ktb: torch.Tensor, ub: torch.Tensor,
                     cblk: torch.Tensor) -> torch.Tensor:
    """The block-sparse SDDMM on given panels (K6): ktb (nb, bv, v_r) Kt
    row panels, ub (nb, v_r, bn) u column panels, cblk (nb, bv, bn) the
    retained tiles of c -> w (nb, bv, bn), w[b] = cblk[b] * (ktb[b] @
    ub[b]) in fp32, computed for every element (an inf product times a
    zero c is NaN)."""
    dev = ktb.device
    for name, t in (("ktb", ktb), ("ub", ub), ("cblk", cblk)):
        _check(name, t, 3, torch.float32, dev)
    nb, bv, v_r = ktb.shape
    bn = ub.shape[2]
    if ub.shape[:2] != (nb, v_r) or cblk.shape != (nb, bv, bn):
        raise ValueError(f"shape mismatch: ktb {tuple(ktb.shape)}, ub "
                         f"{tuple(ub.shape)}, cblk {tuple(cblk.shape)}")
    if dev.type == "cpu":
        return ref.bsr_sddmm_blocks_ref(ktb, ub, cblk)
    w = torch.empty_like(cblk)
    _launch(dev, "bsr_sddmm_blocks", _lib().bsr_sddmm_blocks_launch,
            _ptr(ktb), _ptr(ub), _ptr(cblk), _ptr(w), nb, bv, bn, v_r)
    _count(bsr_sddmm_blocks)
    return w


bsr_sddmm_blocks.launches = 0


def bsr_sddmm(kt: torch.Tensor, u: torch.Tensor, c_bsr) -> torch.Tensor:
    """The block-sparse SDDMM: w = c .* (kt @ u) at the retained tiles
    only. kt (V, v_r) is K transposed, u (v_r, N), ``c_bsr`` a
    :class:`~repro_torch.core.sparse.BlockSparse` over (V, N) on the same
    device -> w blocks (nb, bv, bn) aligned with ``c_bsr``. On the card
    K6 gathers the panels in its load (one launch, counted under
    :func:`bsr_sddmm_blocks`); on the CPU the plain version gathers them
    with ``index_select``. The card does not check the tile coordinates
    (a check would cost a sync): they must lie inside ``c_bsr.shape``, as
    :func:`~repro_torch.core.sparse.block_sparse_from_dense` makes them."""
    blocks, brow, bcol = c_bsr.blocks, c_bsr.brow, c_bsr.bcol
    dev = blocks.device
    _check("kt", kt, 2, torch.float32, dev)
    _check("u", u, 2, torch.float32, dev)
    _check("c_bsr.blocks", blocks, 3, torch.float32, dev)
    for name, t in (("c_bsr.brow", brow), ("c_bsr.bcol", bcol)):
        _check(name, t, 1, torch.int32, dev)
    nb, bv, bn = blocks.shape
    v, v_r = kt.shape
    n = u.shape[1]
    vp, np_ = c_bsr.shape
    if (u.shape[0] != v_r or v > vp or n > np_ or brow.shape != (nb,)
            or bcol.shape != (nb,)):
        raise ValueError(f"shape mismatch: kt {tuple(kt.shape)}, u "
                         f"{tuple(u.shape)}, c_bsr {c_bsr.shape} with "
                         f"blocks {tuple(blocks.shape)}")
    if dev.type == "cpu":
        return ref.bsr_sddmm_blocks_ref(
            *ref.bsr_panels(kt, u, brow, bcol, bv, bn), blocks)
    w = torch.empty_like(blocks)
    _launch(dev, "bsr_sddmm", _lib().bsr_sddmm_launch,
            _ptr(kt), _ptr(u), _ptr(blocks), _ptr(brow), _ptr(bcol), _ptr(w),
            nb, bv, bn, v_r, v, n)
    _count(bsr_sddmm_blocks)
    return w


_COUNTED = (rwmd_min_cdist, sinkhorn_fused_all_batched, cdist_exp,
            sinkhorn_fused_all, sddmm_spmm_step, rwmd_min_cdist_subset,
            bsr_sddmm_blocks)


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    with _COUNT_LOCK:
        for fn in _COUNTED:
            fn.launches = 0


def launches() -> dict:
    with _COUNT_LOCK:
        return {fn.__name__: fn.launches for fn in _COUNTED}
