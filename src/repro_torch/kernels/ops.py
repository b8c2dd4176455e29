"""Wrappers around the port's Hopper kernels.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current CUDA stream, raises
if the launch failed, and adds one to its ``launches`` counter for each
kernel launch (``rwmd_min_cdist`` launches once per 128 support rows, the
solver once per call). A tensor on the CPU goes to the plain version in
:mod:`.ref` instead (and does not count); a CUDA tensor always launches
the kernel — there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref

# per-block dynamic shared memory limit of the H100 (227 KB)
MAX_SMEM_BYTES = 232_448
# support rows per rwmd_min_cdist launch (kMaxB in rwmd_min_cdist.cu); a
# wider query runs as one launch per chunk
RWMD_SUPPORT_CHUNK = 128

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .build import load
        _LIB = load()
    return _LIB


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


def rwmd_min_cdist(a: torch.Tensor, mask: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Masked min-over-support cdist (the RWMD prune stage).
    a (Q, B, w), mask (Q, B), b (V, w) -> minM (Q, V); all-masked rows
    come out +inf. On the card, B > 128 runs as one launch per 128-row
    chunk, each folding its min into the output."""
    dev = a.device
    for name, t, nd in (("a", a, 3), ("mask", mask, 2), ("b", b, 2)):
        _check(name, t, nd, torch.float32, dev)
    q, bq, w = a.shape
    v = b.shape[0]
    if mask.shape != (q, bq) or b.shape[1] != w:
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, mask "
                         f"{tuple(mask.shape)}, b {tuple(b.shape)}")
    if dev.type == "cpu":
        return ref.rwmd_min_cdist_ref(a, mask, b)
    if bq < 1:
        raise ValueError("rwmd_min_cdist needs at least one support row")
    out = torch.empty((q, v), dtype=torch.float32, device=dev)
    _raise_on(_lib().rwmd_min_cdist_launch(
        _ptr(a), _ptr(mask), _ptr(b), _ptr(out), q, bq, w, v,
        _stream(dev)), "rwmd_min_cdist")
    rwmd_min_cdist.launches += -(-bq // RWMD_SUPPORT_CHUNK)
    return out


rwmd_min_cdist.launches = 0


def sinkhorn_fused_all_batched(g: torch.Tensor, val: torch.Tensor,
                               r: torch.Tensor, lam: float, n_iter: int,
                               block_n: int = 128, tol=None,
                               gemm: str = "fp32",
                               log_domain: bool = False, resmask=None,
                               with_iters: bool = False,
                               tile: str = "auto"):
    """Batched fused Sinkhorn solve. g (Q, v_r, N, L) gathered K (log K
    under ``log_domain``; pad query rows 0, or -inf under
    ``log_domain``), val (N, L), r (Q, v_r) with pad rows 1 -> wmd (Q, N)
    and, with ``with_iters``, iters (Q, ceil(N / block_n)).

    Fixed ``n_iter`` only: ``tol``/``resmask`` (the adaptive exit) and
    ``gemm="bf16"`` are not ported yet and raise.
    ``block_n`` only shapes ``iters``; the result does not depend on it.
    ``tile`` picks the kernel's variant on the card: ``"registers"`` (the
    (v_r, L) tile in registers, up to 64 x 64), ``"shared"`` (in shared
    memory, up to the per-block limit) or ``"auto"`` (registers where the
    tile fits). Both compute the same function; the engine always passes
    ``"auto"``, and the other two let tests and ``chip_smoke.py`` hold and
    time the variants against each other at one shape.
    """
    if tol is not None or resmask is not None:
        raise NotImplementedError(
            "the adaptive solve (tol/resmask) is not ported to the Hopper "
            "kernel yet (ROADMAP queue 2, K1 options)")
    if gemm != "fp32":
        raise NotImplementedError(
            f"gemm={gemm!r}: only fp32 operands are ported (ROADMAP queue "
            "2, K1 options)")
    dev = g.device
    _check("g", g, 4, torch.float32, dev)
    _check("val", val, 2, torch.float32, dev)
    _check("r", r, 2, torch.float32, dev)
    q, v_r, n, length = g.shape
    if val.shape != (n, length) or r.shape != (q, v_r):
        raise ValueError(f"shape mismatch: g {tuple(g.shape)}, val "
                         f"{tuple(val.shape)}, r {tuple(r.shape)}")
    if block_n < 1:
        raise ValueError(f"block_n must be positive, got {block_n}")
    if tile not in _TILES:
        raise ValueError(f"tile must be one of {sorted(_TILES)}, got "
                         f"{tile!r}")
    if tile == "registers" and max(v_r, length) > 64:
        raise ValueError(f"tile='registers' holds at most 64 x 64, got "
                         f"v_r={v_r}, L={length}")
    if dev.type == "cpu":
        wmd, iters = ref.sinkhorn_fused_all_batched_ref(
            g, val, r, lam, n_iter, log_domain=log_domain, block_n=block_n)
        return (wmd, iters) if with_iters else wmd
    lib = _lib()
    smem = lib.sinkhorn_fused_smem_bytes(v_r, length, _TILES[tile])
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"sinkhorn_fused_all_batched keeps one (v_r, L) tile in shared "
            f"memory: v_r={v_r}, L={length} needs {smem} B, the limit is "
            f"{MAX_SMEM_BYTES}")
    wmd = torch.empty((q, n), dtype=torch.float32, device=dev)
    iters = torch.empty((q, -(-n // block_n)), dtype=torch.int32,
                        device=dev)
    _raise_on(lib.sinkhorn_fused_batched_launch(
        _ptr(g), _ptr(val), _ptr(r), _ptr(wmd), _ptr(iters), q, v_r, n,
        length, int(n_iter), ctypes.c_float(float(lam)), int(log_domain),
        int(block_n), _TILES[tile], _stream(dev)),
        "sinkhorn_fused_all_batched")
    sinkhorn_fused_all_batched.launches += 1
    return (wmd, iters) if with_iters else wmd


sinkhorn_fused_all_batched.launches = 0
_TILES = {"auto": 0, "registers": 1, "shared": 2}


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    rwmd_min_cdist.launches = 0
    sinkhorn_fused_all_batched.launches = 0


def launches() -> dict:
    return {"rwmd_min_cdist": rwmd_min_cdist.launches,
            "sinkhorn_fused_all_batched": sinkhorn_fused_all_batched.launches}
