"""Property-based tests on the port's mathematical invariants: the mirror
of ``tests/test_properties.py`` at its shapes and example counts, through
the same ``_hypothesis_compat`` shim.

The paper (§2, citing Cuturi'13) claims the Sinkhorn distance is
symmetric, satisfies the triangle inequality and approaches exact EMD for
large lam; the Sinkhorn MoE router balances any logits; and the port's
plain layer loop computes what the reference's remat scan computes."""
import dataclasses

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro_torch.core import one_to_many
from repro_torch.core.sparse import PaddedDocs
from repro_torch.data.corpus import make_corpus

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


def _d(q, docs, vecs, lam, n_iter, impl):
    return one_to_many(q, docs, vecs, lam=lam, n_iter=n_iter, impl=impl,
                       device=CPU).numpy()


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_symmetry(seed):
    """WMD(a, b) == WMD(b, a) (the OT objective is symmetric in the
    marginals when M is symmetric). 1000 iterations where the reference's
    test runs 300: at 300 some corpora have not converged (seed 6095 gives
    2.1232 against 2.1530 in both packages), and hypothesis draws seeds
    at random."""
    corp = make_corpus(vocab_size=256, embed_dim=8, n_docs=4, n_queries=0,
                       seed=seed)
    qa = _doc_as_query(corp.docs, 0, 256)
    qb = _doc_as_query(corp.docs, 1, 256)
    dab = float(_d(qa, corp.docs, corp.vecs, 20.0, 1000,
                   "dense_stabilized")[1])
    dba = float(_d(qb, corp.docs, corp.vecs, 20.0, 1000,
                   "dense_stabilized")[0])
    assert abs(dab - dba) < 5e-3 * max(dab, 1.0), (dab, dba)


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_triangle_inequality(seed):
    """d(a,c) <= d(a,b) + d(b,c) + eps (paper §2: the Sinkhorn distance is
    a metric for large enough entropy)."""
    corp = make_corpus(vocab_size=256, embed_dim=8, n_docs=3, n_queries=0,
                       seed=seed + 77)
    q = [_doc_as_query(corp.docs, j, 256) for j in range(3)]

    def d(i, j):
        return float(_d(q[i], corp.docs, corp.vecs, 30.0, 400,
                        "dense_stabilized")[j])
    dac, dab, dbc = d(0, 2), d(0, 1), d(1, 2)
    assert dac <= dab + dbc + 1e-2, (dac, dab, dbc)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 10_000), scale=st.floats(0.25, 4.0))
def test_scale_equivariance(seed, scale):
    """Scaling embeddings by c scales WMD by c (with lam rescaled by 1/c:
    the transport plan is invariant, the cost is linear in M)."""
    corp = make_corpus(vocab_size=256, embed_dim=8, n_docs=8, n_queries=1,
                       seed=seed)
    q = corp.queries[0]
    d1 = _d(q, corp.docs, corp.vecs, 8.0, 200, "sparse")
    d2 = _d(q, corp.docs, corp.vecs * scale, 8.0 / scale, 200, "sparse")
    np.testing.assert_allclose(d2, d1 * scale, rtol=2e-3, atol=1e-3)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_doc_permutation_equivariance(seed):
    rng = np.random.default_rng(seed)
    corp = make_corpus(vocab_size=256, embed_dim=8, n_docs=16, n_queries=1,
                       seed=seed)
    q = corp.queries[0]
    perm = rng.permutation(16)
    shuffled = PaddedDocs(idx=corp.docs.idx[perm], val=corp.docs.val[perm])
    d1 = _d(q, corp.docs, corp.vecs, 8.0, 60, "sparse")
    d2 = _d(q, shuffled, corp.vecs, 8.0, 60, "sparse")
    np.testing.assert_allclose(d2, d1[perm], rtol=1e-5, atol=1e-5)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 10_000), lam=st.floats(2.0, 12.0))
def test_padding_invariance(seed, lam):
    """Extra ELL padding slots (val == 0) never change distances."""
    corp = make_corpus(vocab_size=256, embed_dim=8, n_docs=8, n_queries=1,
                       seed=seed)
    q = corp.queries[0]
    d1 = _d(q, corp.docs, corp.vecs, lam, 40, "sparse")
    padded = PaddedDocs(idx=np.pad(corp.docs.idx, ((0, 0), (0, 7))),
                        val=np.pad(corp.docs.val, ((0, 0), (0, 7))))
    d2 = _d(q, padded, corp.vecs, lam, 40, "sparse")
    np.testing.assert_allclose(d2, d1, rtol=1e-6, atol=1e-6)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), t=st.integers(2, 6),
       e=st.sampled_from([4, 8, 16]))
def test_sinkhorn_router_marginals(seed, t, e):
    """Row sums == 1; column loads ~uniform, for any logits."""
    from repro_torch.core.router import sinkhorn_route
    rng = np.random.default_rng(seed)
    logits = torch.as_tensor(
        rng.standard_normal((t * 32, e)).astype(np.float32) * 5.0)
    p = sinkhorn_route(logits, n_iter=12).numpy()
    np.testing.assert_allclose(p.sum(1), 1.0, atol=1e-4)
    col = p.sum(0)
    assert col.max() / col.mean() < 1.05, col


def test_two_level_scan_matches_flat():
    """The reference's sqrt-remat grouping (g*k + rem = 2*3 + 1 layers)
    against the port's plain layer loop, with the reference's weights
    carried over."""
    import jax
    from repro.configs.base import get_config
    from repro.models import transformer as T
    from repro_torch.configs.base import get_config as port_config
    from repro_torch.models.convert import from_reference
    cfg = dataclasses.replace(get_config("granite_3_2b").reduced(),
                              num_layers=7)
    params = T.init_params(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                cfg.vocab_size)
    h_remat, _ = T.forward(cfg, params, tokens, remat=True)
    model = from_reference(
        dataclasses.replace(port_config("granite_3_2b").reduced(),
                            num_layers=7),
        jax.tree.map(np.asarray, params), device=CPU)
    with torch.inference_mode():
        h_plain, _ = model(torch.as_tensor(np.array(tokens)))
    np.testing.assert_allclose(h_plain.numpy(), np.asarray(h_remat),
                               rtol=1e-5, atol=1e-5)
