"""Property-based oracle layer over the port's end-to-end retrieval
pipeline: the mirror of ``tests/test_properties_search.py`` at its shapes
and example counts, through the same ``_hypothesis_compat`` shim, on the
port's engine on the host (``impl="sparse"``, the reference's default).

- permutation invariance of the query batch and of the corpus;
- duplicate-doc tie consistency;
- weight-scale invariance;
- recall monotone in ``nprobe`` and exact at the full budget;
- converged log-domain distances approach the LP optimum as lam grows,
  past the point where the linear fp32 path raises ``LamUnderflowError``.
"""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro_torch.core import WmdEngine, build_index
from repro_torch.core.exact_ot import exact_emd
from repro_torch.core.sinkhorn import cdist
from repro_torch.core.sparse import PaddedDocs, padded_docs_from_lists
from repro_torch.data.corpus import dedup_corpus, make_corpus

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tensors are tiny: torch's intra-op threads only contend with
    the other test workers' (two 8-thread processes on 8 cores ran a
    dense_stabilized solve ~50x slower than one thread each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _doc_as_query(docs: PaddedDocs, j: int, vocab: int) -> np.ndarray:
    q = np.zeros(vocab, np.float32)
    idx = np.asarray(docs.idx[j])
    val = np.asarray(docs.val[j])
    q[idx[val > 0]] = val[val > 0]
    return q


def _mk(seed, n_docs=48, n_queries=4, vocab=256):
    return make_corpus(vocab_size=vocab, embed_dim=16, n_docs=n_docs,
                       n_queries=n_queries, words_per_doc=(4, 24), seed=seed)


def _engine(docs, vecs, **kw):
    kw = {"lam": 2.0, "n_iter": 12, **kw}
    index = build_index(docs, vecs, device=CPU,
                        n_clusters=kw.pop("n_clusters", None))
    return WmdEngine(index, impl="sparse", **kw)


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_query_permutation_invariance(seed):
    """Reordering the query batch permutes result rows and nothing else."""
    corp = _mk(seed)
    eng = _engine(corp.docs, corp.vecs)
    qs = list(corp.queries)
    perm = np.random.default_rng(seed).permutation(len(qs))
    res = eng.search(qs, 5, prune="rwmd")
    res_p = eng.search([qs[i] for i in perm], 5, prune="rwmd")
    for row, qi in enumerate(perm):
        assert set(res_p.indices[row].tolist()) == \
            set(res.indices[qi].tolist())
        np.testing.assert_allclose(np.sort(res_p.distances[row]),
                                   np.sort(res.distances[qi]),
                                   rtol=1e-4, atol=1e-5)


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_doc_permutation_invariance(seed):
    """Permuting the corpus before the index build maps retrieved ids
    through the permutation; distances unchanged."""
    corp = _mk(seed)
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(corp.docs.idx.shape[0])
    shuffled = PaddedDocs(idx=corp.docs.idx[perm], val=corp.docs.val[perm])
    eng = _engine(corp.docs, corp.vecs)
    eng_p = _engine(shuffled, corp.vecs)
    qs = list(corp.queries)
    res = eng.search(qs, 5, prune="rwmd")
    res_p = eng_p.search(qs, 5, prune="rwmd")
    for qi in range(len(qs)):
        # shuffled-corpus id j is original id perm[j]
        assert set(perm[res_p.indices[qi]].tolist()) == \
            set(res.indices[qi].tolist())
        np.testing.assert_allclose(np.sort(res_p.distances[qi]),
                                   np.sort(res.distances[qi]),
                                   rtol=1e-3, atol=1e-4)


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_duplicate_doc_tie_consistency(seed):
    """Byte-identical documents enter the top-k together and their
    distances agree to fp."""
    corp = _mk(seed, n_docs=32, n_queries=0)
    idx = np.asarray(corp.docs.idx)
    val = np.asarray(corp.docs.val)
    dup_of = int(np.random.default_rng(seed).integers(0, 32))
    docs = PaddedDocs(idx=np.vstack([idx, idx[dup_of:dup_of + 1]]),
                      val=np.vstack([val, val[dup_of:dup_of + 1]]))
    eng = _engine(docs, corp.vecs)
    q = _doc_as_query(docs, dup_of, 256)
    res = eng.search([q], 4, prune="rwmd")
    got = res.indices[0].tolist()
    assert dup_of in got and 32 in got, got
    d = {i: float(res.distances[0][p]) for p, i in enumerate(got)}
    assert abs(d[dup_of] - d[32]) <= 1e-5 * (1.0 + abs(d[dup_of]))


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 10_000), scale=st.sampled_from([0.25, 3.0, 17.0]))
def test_weight_scale_invariance(seed, scale):
    """Scaling every doc's word counts by one constant rescales distances
    uniformly and leaves the retrieved set and its order unchanged."""
    corp = _mk(seed)
    docs_s = PaddedDocs(idx=corp.docs.idx, val=corp.docs.val * scale)
    eng = _engine(corp.docs, corp.vecs)
    eng_s = _engine(docs_s, corp.vecs)
    qs = list(corp.queries)
    res = eng.search(qs, 5, prune="rwmd")
    res_s = eng_s.search(qs, 5, prune="rwmd")
    for qi in range(len(qs)):
        assert set(res_s.indices[qi].tolist()) == \
            set(res.indices[qi].tolist())
        np.testing.assert_allclose(res_s.distances[qi],
                                   res.distances[qi] * scale,
                                   rtol=1e-3, atol=1e-4)


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_recall_monotone_in_nprobe(seed):
    """IVF cascade recall against the exhaustive top-k is monotone in
    ``nprobe`` (probe sets are nested) and exactly 1 at the full budget."""
    corp = dedup_corpus(64, vocab=512, embed_dim=16, seed=seed)
    eng = _engine(corp.docs, corp.vecs, lam=1.0, n_clusters=8)
    qs = list(corp.queries)
    truth = [set(r.tolist())
             for r in eng.search(qs, 5, prune=None).indices]
    recalls = []
    for nprobe in (1, 2, 4, 8):
        res = eng.search(qs, 5, prune="ivf+wcd+rwmd", nprobe=nprobe)
        hit = sum(len(set(res.indices[qi].tolist()) & truth[qi])
                  for qi in range(len(qs)))
        recalls.append(hit / (5 * len(qs)))
    assert all(b >= a - 1e-9 for a, b in zip(recalls, recalls[1:])), recalls
    assert recalls[-1] == 1.0, recalls


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_search_distances_approach_exact_emd(seed):
    """End-to-end distances converge to the LP optimum as lam grows: the
    linear fp32 path raises ``LamUnderflowError`` at lam=40, while
    ``precision="log"`` completes and the query's source document tightens
    onto the scipy ``exact_emd`` oracle (5% at lam=40 against the entropy
    gap's 25% at lam=10). Torch keeps fp32 denormals where XLA flushes
    them, so the port's linear path raises from a larger lam than the
    reference's (P2); on this corpus both onsets lie below 40."""
    from repro_torch.core import LamUnderflowError
    rng = np.random.default_rng(seed)
    base = make_corpus(vocab_size=128, embed_dim=8, n_docs=6, n_queries=0,
                       words_per_doc=(4, 10), seed=seed)
    idx = np.asarray(base.docs.idx)
    val = np.asarray(base.docs.val)
    # normalize doc marginals so the LP and the engine agree on mass
    norm = [(idx[j][val[j] > 0], val[j][val[j] > 0] / val[j][val[j] > 0].sum())
            for j in range(6)]
    docs = padded_docs_from_lists([i for i, _ in norm], [c for _, c in norm])
    src = int(rng.integers(0, 6))
    q = np.zeros(128, np.float32)
    ids, cts = norm[src]
    q[ids] = cts
    index = build_index(docs, base.vecs, device=CPU)
    vecs = np.asarray(base.vecs)
    r = (q[q > 0] / q[q > 0].sum()).astype(np.float64)
    vecs_sel = vecs[np.nonzero(q > 0)[0]]
    m_src = cdist(torch.as_tensor(vecs_sel),
                  torch.as_tensor(vecs[ids])).numpy().astype(np.float64)
    lp = exact_emd(r, np.asarray(norm[src][1], np.float64), m_src)

    def src_dist(lam, n_iter):
        eng = WmdEngine(index, lam=lam, n_iter=n_iter, impl="sparse",
                        precision="log")
        res = eng.search([q], 6, prune=None)
        pos = res.indices[0].tolist().index(src)
        return float(res.distances[0][pos])

    try:
        WmdEngine(index, lam=40.0, n_iter=5, impl="sparse").query_batch([q])
        raise AssertionError("expected LamUnderflowError on the linear "
                             "path at lam=40")
    except LamUnderflowError:
        pass
    assert abs(src_dist(10.0, 200) - lp) <= 0.25 * lp + 0.05
    assert abs(src_dist(40.0, 600) - lp) <= 0.05 * lp + 0.02
