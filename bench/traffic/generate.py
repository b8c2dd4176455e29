"""The benchmark's own corpus and query-pool generator (frozen: later
changes to the program do not change what is measured), and the default
corpus: it draws every configuration that names no ``corpus`` of its own
(``bench/corpora/<corpus>.py``, found by ``bench.wmdbench.cell``). A
corpus module may use the helpers here (``rng``, ``generator``, ``Bags``,
``draw_bags``, ``to_ell``) and returns its ``Corpus``.

A document or query is drawn as in the program's ``make_corpus``
(``src/repro_torch/data/corpus.py``): Zipf-drawn ranks (exponent
``zipf_a``, clipped to the vocabulary) whose distinct values become the
bag of words with their multiplicities as counts, and each distinct rank
mapped to a uniformly drawn distinct word id of the vocabulary
(``make_corpus`` does this with a fresh permutation of the vocabulary per
document). Counts are normalised to frequencies.

A length law (``doc_words``, ``query_pool.words``) gives each bag a
number: of draws (``"count": "draws"``, the default, as ``make_corpus``),
or of distinct words (``"count": "unique"``: ranks are drawn until that
many distinct ones appeared). The numbers are the law's quantiles (uniform,
or log-normal for a tail of long documents) in an order drawn from the
seed, so every seed makes the same set of lengths; a query pool repeats
the quantiles of ``query_pool.block`` in each block of that many queries,
so that every whole block of it, as a window uses it, has that set too. Under ``max_unique`` a
bag keeps at most that many distinct words, its commonest (lowest ranks).

What differs from ``make_corpus``: everything is drawn in bulk on the
run's device with a ``torch.Generator`` (``make_corpus`` permutes the whole
vocabulary once per document and draws its Zipf ranks with numpy on the
host, which at these sizes takes seconds of every run's set-up); a Zipf
rank is the inverse of its clipped law's table at a uniform draw. The
embeddings are Gaussian, drawn on the device in one call.

Everything takes the seed as an argument; the program receives only the
arrays made here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# independent random streams of one seed
STREAM_EMBED, STREAM_DOCS, STREAM_POOL, STREAM_SAMPLE = 1, 2, 3, 4
# draws handled at once on the device (bounds the generator's memory)
BLOCK_DRAWS = 1 << 20


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, stream])


def torch_seed(seed: int, stream: int) -> int:
    return (int(seed) % 2**61) * 8 + stream


def generator(seed: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, stream))
    return gen


class Bags(NamedTuple):
    """Bags of words in CSR form: bag i holds ``ids[ptr[i]:ptr[i+1]]``
    with frequencies ``w[...]`` (summing to 1)."""
    ptr: np.ndarray     # (n + 1,) int64
    ids: np.ndarray     # (nnz,) int64, distinct within a bag
    w: np.ndarray       # (nnz,) float32

    @property
    def n(self) -> int:
        return self.ptr.size - 1

    def sizes(self) -> np.ndarray:
        return np.diff(self.ptr)


def draw_lengths(gen: torch.Generator, n: int, spec: dict,
                 block: int | None = None) -> torch.Tensor:
    """The number of each of ``n`` bags: in each block of ``block`` bags
    (all ``n`` by default) the law's ``block`` quantiles at
    (i + 1/2)/block, in an order drawn from the seed, so that every seed,
    and every whole block of a pool used in order, has the same set of
    lengths (and of work) in another order."""
    block = min(int(block or n), n)
    kind = spec["kind"]
    q = (torch.arange(block, dtype=torch.float64) + 0.5) / block
    if kind == "uniform":
        lo, hi = spec["low"], spec["high"]
        x = lo + torch.floor(q * (hi - lo + 1))
    elif kind == "lognormal":
        x = torch.exp(np.log(spec["median"])
                      + spec["sigma"] * torch.special.ndtri(q))
    else:
        raise ValueError(f"unknown length law {kind!r}")
    x = torch.clamp(torch.round(x), min=1).to(torch.int64)
    out = [x[torch.randperm(block, generator=gen, device=gen.device).cpu()]
           for _ in range(-(-n // block))]
    return torch.cat(out)[:n]


def zipf_table(vocab: int, a: float, device) -> torch.Tensor:
    """(vocab - 1,) float64: P(rank <= r) for r < vocab - 1 of numpy's
    ``zipf(a)`` clipped to ``vocab``, less one; the last rank takes the
    rest of the mass."""
    k = torch.arange(1, vocab, dtype=torch.float64, device=device)
    zeta = torch.special.zeta(torch.tensor(float(a), dtype=torch.float64),
                              torch.tensor(1.0, dtype=torch.float64))
    return torch.cumsum(k ** -float(a), 0) / zeta.item()


def _first_seen(key: torch.Tensor) -> torch.Tensor:
    """Positions (ascending) of the first occurrence of each value."""
    skey, perm = torch.sort(key, stable=True)
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    return torch.sort(perm[first]).values


def _distinct_ranks(gen, counts, unique: bool, table, vocab: int):
    """(bag, rank, multiplicity) of the distinct ranks of bags whose
    numbers are ``counts`` (a device tensor): ``counts`` draws each, or
    draws until ``counts`` distinct ranks appeared (``unique``), sorted by
    bag then rank."""
    dev = counts.device
    n = counts.numel()
    todo = torch.arange(n, device=dev)
    factor = 4 if unique else 1
    out = []
    while todo.numel():
        m = counts[todo] * factor
        local = torch.repeat_interleave(torch.arange(todo.numel(),
                                                     device=dev), m)
        u = torch.rand(local.numel(), generator=gen, dtype=torch.float64,
                       device=dev)
        key = local * vocab + torch.searchsorted(table, u)
        keep = torch.ones_like(key, dtype=torch.bool)
        done = torch.ones(todo.numel(), dtype=torch.bool, device=dev)
        if unique:                  # cut each stream at its t-th new rank
            ff = _first_seen(key)
            seen = torch.bincount(local[ff], minlength=todo.numel())
            done = seen >= counts[todo]
            last = torch.cumsum(seen, 0) - seen + counts[todo] - 1
            cut = torch.where(done, ff[torch.clamp(last, max=ff.numel() - 1)],
                              torch.full_like(last, -1))
            keep = torch.arange(key.numel(), device=dev) <= cut[local]
        k, mult = torch.unique(key[keep], return_counts=True)
        out.append((todo[k // vocab], k % vocab, mult))
        todo = todo[~done]
        factor *= 2                 # a stream cut short is drawn anew
    bag, rank, mult = (torch.cat(x) for x in zip(*out))
    order = torch.argsort(bag * vocab + rank)
    return bag[order], rank[order], mult[order]


def draw_bags(gen: torch.Generator, n: int, vocab: int, spec: dict,
              zipf_a: float, block: int | None = None) -> Bags:
    """``n`` bags of words over ``vocab`` ids drawn on ``gen``'s device
    (see the module docstring); ``spec`` is the length law, ``block`` as
    :func:`draw_lengths`."""
    dev = gen.device
    counts = draw_lengths(gen, n, spec, block).to(dev)
    unique = spec.get("count", "draws") == "unique"
    table = zipf_table(vocab, zipf_a, dev)
    # blocks of about BLOCK_DRAWS first draws
    csum = np.cumsum(counts.cpu().numpy() * (4 if unique else 1))
    cuts = np.searchsorted(csum, np.arange(BLOCK_DRAWS, csum[-1],
                                           BLOCK_DRAWS), side="right")
    edges = np.unique(np.concatenate([[0], cuts, [n]]))
    parts = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        bag, rank, mult = _distinct_ranks(gen, counts[lo:hi], unique, table,
                                          vocab)
        parts.append((bag + int(lo), rank, mult))
    bag, rank, mult = (torch.cat(x) for x in zip(*parts))
    size = torch.bincount(bag, minlength=n)
    cap = spec.get("max_unique")
    if cap is not None:             # keep the commonest (lowest) ranks
        start = torch.cumsum(size, 0) - size
        slot = torch.arange(bag.numel(), device=dev) - start[bag]
        keep = slot < cap
        bag, mult = bag[keep], mult[keep]
        size = torch.clamp(size, max=cap)
    ids = torch.randint(0, vocab, (bag.numel(),), generator=gen, device=dev)
    while True:                     # distinct ids within a bag
        dup = torch.ones_like(ids, dtype=torch.bool)
        dup[_first_seen(bag * vocab + ids)] = False
        n_dup = int(dup.sum())
        if not n_dup:
            break
        ids[dup] = torch.randint(0, vocab, (n_dup,), generator=gen,
                                 device=dev)
    mult = mult.to(torch.float64)
    total = torch.zeros(n, dtype=torch.float64, device=dev)
    total.index_add_(0, bag, mult)
    w = (mult / total[bag]).to(torch.float32)
    ptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                     torch.cumsum(size, 0)])
    return Bags(ptr=ptr.cpu().numpy(), ids=ids.cpu().numpy(),
                w=w.cpu().numpy())


def to_ell(bags: Bags) -> tuple[np.ndarray, np.ndarray]:
    """(idx (n, L) int32, val (n, L) float32): the ELL layout
    ``PaddedDocs`` takes, padded to the widest bag with id 0 and 0."""
    size = bags.sizes()
    n, length = bags.n, max(1, int(size.max(initial=0)))
    row = np.repeat(np.arange(n), size)
    slot = np.arange(bags.ids.size) - np.repeat(bags.ptr[:-1], size)
    idx = np.zeros((n, length), np.int32)
    val = np.zeros((n, length), np.float32)
    idx[row, slot] = bags.ids
    val[row, slot] = bags.w
    return idx, val


class Corpus(NamedTuple):
    vecs: torch.Tensor      # (V, w) fp32 on the run's device
    docs: Bags              # the N target documents
    idx: np.ndarray         # (N, L) int32 ELL word ids
    val: np.ndarray         # (N, L) float32 ELL frequencies
    pool: Bags              # the query pool, used in order


def make(config: dict, seed: int, device) -> Corpus:
    """The configuration's corpus and query pool for ``seed``."""
    v, w = config["vocab_size"], config["embed_dim"]
    device = torch.device(device)
    vecs = torch.randn((v, w), generator=generator(seed, STREAM_EMBED, device),
                       device=device, dtype=torch.float32)
    docs = draw_bags(generator(seed, STREAM_DOCS, device), config["n_docs"],
                     v, config["doc_words"], config["zipf_a"])
    pool_spec = config["query_pool"]
    pool = draw_bags(generator(seed, STREAM_POOL, device), pool_spec["size"],
                     v, pool_spec["words"], config["zipf_a"],
                     pool_spec.get("block"))
    idx, val = to_ell(docs)
    return Corpus(vecs=vecs, docs=docs, idx=idx, val=val, pool=pool)


class DenseRows:
    """Full-vocabulary query rows (what the program's entries take) made
    from pool bags into one reused buffer: only the entries the previous
    fill set are cleared."""

    def __init__(self, rows: int, vocab: int):
        self.buf = np.zeros((rows, vocab), np.float32)
        self._set: list[tuple[np.ndarray, np.ndarray]] = []

    def fill(self, pool: Bags, positions) -> np.ndarray:
        for r, ids in self._set:
            self.buf[r, ids] = 0.0
        self._set = []
        for r, p in enumerate(positions):
            lo, hi = pool.ptr[p], pool.ptr[p + 1]
            self.buf[r, pool.ids[lo:hi]] = pool.w[lo:hi]
            self._set.append((r, pool.ids[lo:hi]))
        return self.buf[:len(positions)]
