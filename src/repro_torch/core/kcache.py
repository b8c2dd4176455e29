"""Cross-request cache of per-word corpus-distance rows (port of
``repro.core.kcache``).

Query traffic is Zipfian over the vocabulary, so the same query words —
and the same (V,) distance rows against the frozen vocabulary — recur
between requests. :class:`KCache` keeps the hot words' rows on the device
in a fixed number of slots with an LRU clock, and the engine
(``WmdEngine(impl="sparse", kcache_slots=...)``) assembles a chunk's K
block from cached rows plus a GEMM over the misses only.

- The cache stores the raw distance row ``m[w] = ||vecs - vecs[w]||``,
  which depends on neither ``lam`` nor the solve's domain: the linear path
  derives ``exp(-lam*m)`` and the log path ``-lam*m`` elementwise at
  assembly (:func:`assemble_kq`). The GEMM precision is part of the
  cache's identity: bf16 operands change ``m`` itself.
- Bit-exactness. Cache-on results must equal cache-off results bit for
  bit. Both the engine's stacked K block (``index._compute_kq`` with
  ``with_m=True``) and the misses go through :func:`cdist_rows`, which
  runs the product in panels of ``KQ_PANEL`` words, the last one padded
  with zero rows: a GEMM library picks its kernel, and with it each
  element's summation order, by shape, and one panel shape gives every
  word's row the same kernel wherever the word sits. The squared norms
  are taken per panel too.
- Dispatch economy: the cached path costs a gather, a misses-only GEMM
  and a scatter instead of one stacked GEMM, so the engine falls back to
  the stacked GEMM below ``kcache_min_hits`` resident words, and warms the
  cache from that chunk's distance block (:meth:`KCache.warm`).

Validity: the cache is keyed to one embedding table by object identity
(:attr:`KCache.vecs`). ``append_docs`` keeps ``vecs``, so appends are
cache-safe; the engine rebinds (:meth:`KCache.rebind`, every entry
dropped) when the index's table is another object.

The reference pads the unique-id and miss counts to powers of two to
bound its compiled shapes; eager torch compiles nothing, so the port
works on the exact counts and needs no scratch row. Not thread-safe: one
cache belongs to one engine.
"""
from __future__ import annotations

import numpy as np
import torch

from .sinkhorn import gemm_round

# words per GEMM panel of cdist_rows: every distance row comes out of a
# (KQ_PANEL, w) x (w, V) product
KQ_PANEL = 64


def cdist_rows(a: torch.Tensor, vecs: torch.Tensor, vecs_sq: torch.Tensor,
               gemm: str = "fp32") -> torch.Tensor:
    """(U, w) word embeddings -> (U, V) distance rows against the whole
    vocabulary, ``sqrt(max(|a|^2 + |b|^2 - 2 a.b, 0))``, computed in
    panels of :data:`KQ_PANEL` words (the last zero-padded), so a word's
    row does not depend on which other words share its call.
    ``gemm="bf16"`` rounds both operands of the product to bf16; the
    product's sums and the norms stay fp32."""
    u, w = a.shape
    gd = torch.bfloat16 if gemm == "bf16" else None
    b = gemm_round(vecs, gd).T                            # (w, V)
    out = torch.empty((u, vecs.shape[0]), dtype=torch.float32,
                      device=vecs.device)
    for lo in range(0, u, KQ_PANEL):
        hi = min(lo + KQ_PANEL, u)
        panel = torch.zeros((KQ_PANEL, w), dtype=torch.float32,
                            device=vecs.device)
        panel[:hi - lo] = a[lo:hi]
        a2 = (panel * panel).sum(-1)                      # (P,)
        ab = torch.matmul(gemm_round(panel, gd), b)       # (P, V)
        d2 = torch.clamp(a2[:, None] + vecs_sq[None, :] - 2.0 * ab,
                         min=0.0)
        out[lo:hi] = torch.sqrt(d2)[:hi - lo]
    return out


def _cdist_rows(ids: torch.Tensor, vecs: torch.Tensor,
                vecs_sq: torch.Tensor, gemm: str = "fp32") -> torch.Tensor:
    """(U,) word ids -> their (U, V) distance rows (:func:`cdist_rows`)."""
    return cdist_rows(vecs[ids], vecs, vecs_sq, gemm)


def _scatter_rows(store: torch.Tensor, slots, rows: torch.Tensor) -> None:
    """Write ``rows`` into ``store`` at ``slots``, in place."""
    store[torch.as_tensor(slots, dtype=torch.int64,
                          device=store.device)] = rows


def _gather_rows(store: torch.Tensor, slots) -> torch.Tensor:
    return store[torch.as_tensor(slots, dtype=torch.int64,
                                 device=store.device)]


def _extract_rows(mq: torch.Tensor, qq, bb) -> torch.Tensor:
    """Rows out of a staged chunk's (Q, V, B) distance block: the row of
    word ``sup[qq[i], bb[i]]`` is ``mq[qq[i], :, bb[i]]`` -> (U, V)."""
    dev = mq.device
    return mq[torch.as_tensor(qq, dtype=torch.int64, device=dev), :,
              torch.as_tensor(bb, dtype=torch.int64, device=dev)]


def kq_from_m(m: torch.Tensor, mask: torch.Tensor, lam: float,
              log_domain: bool = False) -> torch.Tensor:
    """A chunk's (Q, V, B) distance block -> its K block: ``exp(-lam*m)``
    on live query rows and 0 on pad rows, or ``-lam*m`` and -inf under
    ``log_domain``. One elementwise formula for the cached and the
    uncached path, so equal ``m`` gives equal K."""
    live = mask[:, None, :] > 0
    if log_domain:
        return torch.where(live, -lam * m, torch.full_like(m, -float("inf")))
    return torch.exp(-lam * m) * live.to(m.dtype)


def assemble_kq(rows: torch.Tensor, inv, mask: torch.Tensor, lam: float,
                log_domain: bool = False):
    """Cached rows -> the ``(kq, mq)`` pair the uncached stacked GEMM
    gives. ``rows`` (U, V) distance rows, ``inv`` (Q, B) each chunk slot's
    row. ``mq`` stays unmasked, as in the uncached pair: pad slots carry
    word 0's row and the solve's distance line excludes them (G == 0)."""
    inv = torch.as_tensor(inv, dtype=torch.int64, device=rows.device)
    m = rows[inv].transpose(1, 2).contiguous()            # (Q, V, B)
    return kq_from_m(m, mask, lam, log_domain), m


class KCache:
    """Fixed-capacity device-resident cache of distance rows with an LRU
    clock. ``slots`` bounds device memory at ``slots * V`` floats; the host
    keeps the word -> slot map and each slot's last use.

    Counters (:meth:`stats`): ``hits``/``misses`` count word lookups over
    all traffic (also the chunks the engine then served by the stacked
    GEMM), ``evictions`` LRU replacements, ``inserts`` rows written,
    ``lookups`` staged chunks, ``fallbacks`` chunks served by the stacked
    GEMM, ``oversize`` chunks with more unique words than slots."""

    def __init__(self, vecs: torch.Tensor, vecs_sq: torch.Tensor,
                 slots: int, gemm: str = "fp32"):
        if slots < 1:
            raise ValueError(f"kcache needs at least 1 slot, got {slots}")
        self.vecs = vecs
        self.vecs_sq = vecs_sq
        self.slots = int(slots)
        self.gemm = gemm
        self._store = torch.zeros((self.slots, vecs.shape[0]),
                                  dtype=vecs.dtype, device=vecs.device)
        self._slot_of: dict[int, int] = {}
        self._word_of = np.full(self.slots, -1, np.int64)
        self._last_use = np.zeros(self.slots, np.int64)
        self._tick = 0
        self.reset_counters()

    # ------------------------------------------------------------ queries
    def reset_counters(self) -> None:
        self.hits = self.misses = self.evictions = 0
        self.inserts = self.lookups = self.fallbacks = self.oversize = 0

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"slots": self.slots, "used": len(self._slot_of),
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "inserts": self.inserts,
                "lookups": self.lookups, "fallbacks": self.fallbacks,
                "oversize": self.oversize,
                "hit_rate": round(self.hits / total, 4) if total else 0.0}

    def lookup(self, ids: np.ndarray) -> int:
        """Count one chunk's unique word ids against the resident set (the
        engine's cached-or-fallback decision). Updates the hit and miss
        counters, not the LRU clock."""
        n_hit = sum(1 for w in ids if int(w) in self._slot_of)
        self.lookups += 1
        self.hits += n_hit
        self.misses += len(ids) - n_hit
        return n_hit

    def note_fallback(self, oversize: bool = False) -> None:
        """The engine served a chunk by the stacked GEMM: below the hit
        threshold, or with more unique words than slots (``oversize``)."""
        self.fallbacks += 1
        if oversize:
            self.oversize += 1

    # ------------------------------------------------------------- slots
    def _claim_slots(self, miss_ids, keep: set) -> np.ndarray:
        """One slot per miss id: free slots first, then LRU victims, never
        a slot holding a word of the current chunk (``keep``)."""
        out = np.empty(len(miss_ids), np.int64)
        free = np.nonzero(self._word_of < 0)[0]
        n_free = min(free.size, len(miss_ids))
        out[:n_free] = free[:n_free]
        need = len(miss_ids) - n_free
        if need > 0:
            order = np.argsort(self._last_use, kind="stable")
            victims = [s for s in order
                       if self._word_of[s] >= 0
                       and int(self._word_of[s]) not in keep]
            assert len(victims) >= need, "kcache slot accounting broken"
            for j, s in enumerate(victims[:need]):
                del self._slot_of[int(self._word_of[s])]
                self.evictions += 1
                out[n_free + j] = s
        for w, s in zip(miss_ids, out):
            self._slot_of[int(w)] = int(s)
            self._word_of[s] = int(w)
        return out

    def _insert(self, miss_ids, rows: torch.Tensor, keep: set) -> None:
        """Write freshly computed rows for ``miss_ids``. ``keep`` is the
        current chunk's word set: its slots are not evicted."""
        slots = self._claim_slots(miss_ids, keep)
        _scatter_rows(self._store, slots, rows)
        self._last_use[slots] = self._tick
        self.inserts += len(miss_ids)

    # -------------------------------------------------------------- rows
    def rows(self, ids: np.ndarray) -> torch.Tensor:
        """(U,) sorted unique word ids -> (U, V) resident rows. Misses are
        computed by :func:`_cdist_rows` and inserted; every id's slot is
        touched on the LRU clock. Counting is :meth:`lookup`'s job: call
        it first."""
        assert len(ids) <= self.slots, "caller must fall back on oversize"
        self._tick += 1
        miss = [int(w) for w in ids if int(w) not in self._slot_of]
        # touch the hits before claiming miss slots, so this chunk's own
        # rows are never the victims of its own misses
        hit_slots = [self._slot_of[int(w)] for w in ids
                     if int(w) in self._slot_of]
        if hit_slots:
            self._last_use[np.asarray(hit_slots)] = self._tick
        if miss:
            fresh = _cdist_rows(
                torch.as_tensor(miss, dtype=torch.int64,
                                device=self.vecs.device),
                self.vecs, self.vecs_sq, gemm=self.gemm)
            self._insert(miss, fresh, keep=set(int(w) for w in ids))
        return _gather_rows(self._store, [self._slot_of[int(w)] for w in ids])

    def warm(self, sup_np: np.ndarray, mq: torch.Tensor) -> None:
        """Insert a fallback chunk's rows from its (Q, V, B) distance block,
        the rows :meth:`rows` would have computed, at the cost of one
        gather. Warming never evicts: only free slots are filled."""
        self._tick += 1
        flat = sup_np.reshape(-1)
        ids, first = np.unique(flat, return_index=True)
        fresh = [(int(w), int(f)) for w, f in zip(ids, first)
                 if int(w) not in self._slot_of]
        # the resident rows were just used by this chunk
        hit_slots = [self._slot_of[int(w)] for w in ids
                     if int(w) in self._slot_of]
        if hit_slots:
            self._last_use[np.asarray(hit_slots)] = self._tick
        room = self.slots - len(self._slot_of)
        if room <= 0 or not fresh:
            return
        fresh = fresh[:room]
        b = sup_np.shape[1]
        qq = [f // b for _, f in fresh]
        bb = [f % b for _, f in fresh]
        self._insert([w for w, _ in fresh], _extract_rows(mq, qq, bb),
                     keep=set(int(w) for w in ids))

    # ----------------------------------------------------------- validity
    def rebind(self, vecs: torch.Tensor, vecs_sq: torch.Tensor) -> "KCache":
        """The table this cache was built against is gone: a fresh cache
        bound to the new one, every entry dropped, the counters kept."""
        fresh = KCache(vecs, vecs_sq, self.slots, gemm=self.gemm)
        for k in ("hits", "misses", "evictions", "inserts", "lookups",
                  "fallbacks", "oversize"):
            setattr(fresh, k, getattr(self, k))
        return fresh
