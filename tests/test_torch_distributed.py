"""The port's distributed solvers (``repro_torch.core.distributed``) and
mesh collectives (``repro_torch.runtime.sharding``) on the CPU, in one
process, over meshes whose positions all sit on ``"cpu"``.

The reference's own multi-device test fails on jax 0.9 (ROADMAP queue 3,
R3), so the yardstick is ``one_to_many(impl="sparse")`` at the
reference test's tolerance (abs 1e-3), as ``tests/test_distributed.py``
holds its solvers. On the reference's one-position (1, 1) mesh, which
runs in-process on jax 0.9, the port is held to the reference's
distributed solver itself: distances at ``R2`` (rtol 1e-3, atol 5e-3:
lam=8, where the two packages' fp32 GEMMs differ by up to 1.3e-4
relative, P1) and realized iterations exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import select_support as ref_select_support
from repro.core.distributed import \
    sinkhorn_wmd_sparse_distributed as ref_sparse_distributed
from repro_torch.core import one_to_many, select_support
from repro_torch.core.distributed import (sharded_inputs,
                                          sinkhorn_wmd_dense_distributed,
                                          sinkhorn_wmd_sparse_distributed)
from repro_torch.core.sinkhorn_sparse import sinkhorn_wmd_sparse
from repro_torch.core.sparse import PaddedDocs, padded_docs_to_dense
from repro_torch.data.corpus import make_corpus, shard_balanced
from repro_torch.runtime import sharding
from repro_torch.runtime.sharding import count_collectives, make_mesh

ATOL = 1e-3
R2 = dict(rtol=1e-3, atol=5e-3)
LAM, N_ITER = 8.0, 40
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread runs them faster, and far faster
    when several test workers share the host. Restored afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def case():
    c = make_corpus(vocab_size=512, embed_dim=16, n_docs=64, n_queries=2,
                    seed=2)
    q = c.queries[0]
    ref = one_to_many(q, c.docs, c.vecs, lam=LAM, n_iter=N_ITER,
                      impl="sparse", device="cpu").numpy()
    r, vs, _ = select_support(q, torch.as_tensor(c.vecs))
    return c, ref, r, vs


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_distributed_all_variants(case, mesh_name):
    """Dense, and sparse with vshard off and on, over the reference
    test's (2, 4) and (2, 2, 2) meshes, equal one_to_many(impl="sparse")."""
    c, ref, r, vs = case
    mesh = make_mesh(*MESHES[mesh_name], devices=["cpu"])
    cd = padded_docs_to_dense(c.docs, 512)
    dd = sinkhorn_wmd_dense_distributed(r, vs, c.vecs, cd, LAM, N_ITER,
                                        mesh).numpy()
    assert np.abs(dd - ref).max() < ATOL, "dense"
    for vp in (False, True):
        ds = sinkhorn_wmd_sparse_distributed(r, vs, c.vecs, c.docs, LAM,
                                             N_ITER, mesh,
                                             vshard_precompute=vp).numpy()
        assert np.abs(ds - ref).max() < ATOL, ("sparse", vp)


def test_shard_balanced_preserves_the_distance_multiset(case):
    c, ref, r, vs = case
    sb = shard_balanced(c.docs, 8)
    mesh = make_mesh(*MESHES["2x4"], devices=["cpu"])
    db = sinkhorn_wmd_sparse_distributed(r, vs, c.vecs, sb, LAM, N_ITER,
                                         mesh, vshard_precompute=True)
    assert np.allclose(np.sort(db.numpy()), np.sort(ref), atol=ATOL)


def test_collectives_of_each_solver(case):
    """The fixed sparse loop runs none (vshard adds its one psum_scatter
    before the loop), the adaptive loop only pmax, one per check; the
    dense solver one psum per iteration and one for the distance line."""
    c, _, r, vs = case
    mesh = make_mesh(*MESHES["2x4"], devices=["cpu"])
    kw = dict(check_underflow=False)
    assert count_collectives(sinkhorn_wmd_sparse_distributed, r, vs, c.vecs,
                             c.docs, LAM, 10, mesh, vshard_precompute=False,
                             **kw) == {}
    assert count_collectives(sinkhorn_wmd_sparse_distributed, r, vs, c.vecs,
                             c.docs, LAM, 10, mesh, vshard_precompute=True,
                             **kw) == {"psum_scatter": 1}
    out = {}

    def adaptive():
        out["d"], out["it"] = sinkhorn_wmd_sparse_distributed(
            r, vs, c.vecs, c.docs, LAM, 13, mesh, vshard_precompute=False,
            tol=1e-12, check_every=4, return_iters=True, **kw)

    colls = count_collectives(adaptive)
    # 1 seeded iteration, then checks at 5, 9, 13: three pmax
    assert colls == {"pmax": 3} and out["it"].tolist() == [13]
    cd = padded_docs_to_dense(c.docs, 512)
    assert count_collectives(sinkhorn_wmd_dense_distributed, r, vs, c.vecs,
                             cd, LAM, 7, mesh) == {"psum": 8}


@pytest.mark.parametrize("vshard", [False, True])
@pytest.mark.parametrize("tol", [None, 1e-3])
def test_matches_reference_on_its_one_position_mesh(case, vshard, tol):
    """The reference's sinkhorn_wmd_sparse_distributed on a (1, 1) mesh
    in-process and the port's on a (1, 1) mesh of "cpu": distances at R2,
    realized iterations equal."""
    c = case[0]
    q = c.queries[0]
    rr, rvs, _ = ref_select_support(q, c.vecs)
    want, want_it = ref_sparse_distributed(
        rr, rvs, jnp.asarray(c.vecs), c.docs, LAM, N_ITER,
        jax.make_mesh((1, 1), ("data", "model")), vshard_precompute=vshard,
        tol=tol, return_iters=True)
    r, vs, _ = select_support(q, torch.as_tensor(c.vecs))
    got, got_it = sinkhorn_wmd_sparse_distributed(
        r, vs, c.vecs, c.docs, LAM, N_ITER,
        make_mesh((1, 1), ("data", "model"), ["cpu"]),
        vshard_precompute=vshard, tol=tol, return_iters=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **R2)
    assert got_it.tolist() == np.asarray(want_it).tolist()


def test_batched_queries_with_padding_match_each_query_alone(case):
    """Two queries padded to one v_r with qmask (pad rows r=1, qmask=0)
    solve as each would alone: fixed, and adaptive with per-query
    realized counts."""
    c = case[0]
    sup = [select_support(q, torch.as_tensor(c.vecs))[:2]
           for q in c.queries]
    v_r = max(s[0].shape[0] for s in sup)
    w = c.vecs.shape[1]
    r = torch.ones((2, v_r))
    sel = torch.zeros((2, v_r, w))
    qmask = torch.zeros((2, v_r))
    for i, (ri, si) in enumerate(sup):
        n = ri.shape[0]
        r[i, :n], sel[i, :n], qmask[i, :n] = ri, si, 1.0
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"])
    vecs = torch.as_tensor(c.vecs)
    docs = PaddedDocs(idx=torch.as_tensor(c.docs.idx, dtype=torch.int64),
                      val=torch.as_tensor(c.docs.val))
    for tol in (None, 1e-3):
        got, it = sinkhorn_wmd_sparse_distributed(
            r, sel, c.vecs, c.docs, LAM, N_ITER, mesh, qmask=qmask,
            tol=tol, return_iters=True)
        assert got.shape == (2, 64)
        for i, (ri, si) in enumerate(sup):
            want, want_it = sinkhorn_wmd_sparse(ri, si, vecs, docs, LAM,
                                                N_ITER, tol=tol,
                                                return_iters=True)
            np.testing.assert_allclose(got[i].numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-5)
            assert int(it[i]) == int(want_it)


def test_sharded_inputs_sit_on_the_first_position(case):
    c, ref, r, vs = case
    mesh = make_mesh(*MESHES["2x4"], devices=["cpu"])
    inp = sharded_inputs(mesh, r, vs, c.vecs, c.docs)
    assert inp["docs"].idx.dtype == torch.int64
    assert all(t.device == mesh.devices[0]
               for t in (inp["r"], inp["vecs"], inp["docs"].val))
    out = sinkhorn_wmd_sparse_distributed(
        inp["r"], inp["vecs_sel"], inp["vecs"], inp["docs"], LAM, N_ITER,
        mesh)
    assert np.abs(out.numpy() - ref).max() < ATOL
    with pytest.raises(ValueError, match="does not split"):
        sinkhorn_wmd_sparse_distributed(
            r, vs, c.vecs, PaddedDocs(c.docs.idx[:63], c.docs.val[:63]),
            LAM, N_ITER, mesh, vshard_precompute=False)


# ------------------------------------------------------------ collectives
def test_collectives_match_numpy():
    """psum, pmax and psum_scatter over one axis of a (2, 3) mesh, and the
    all_gather of every position, against numpy."""
    mesh = make_mesh((2, 3), ("a", "b"), ["cpu"])
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((4, 6)).astype(np.float32) for _ in range(6)]
    parts = [torch.as_tensor(x) for x in xs]
    grid = np.stack(xs).reshape(2, 3, 4, 6)
    summed = sharding.psum(mesh, parts, "b")
    top = sharding.pmax(mesh, parts, ("a",))
    tiles = sharding.psum_scatter(mesh, parts, "b", dim=1)
    for p, (i, j) in enumerate(mesh.coords()):
        np.testing.assert_allclose(summed[p].numpy(), grid[i].sum(0),
                                   rtol=1e-6)
        assert np.array_equal(top[p].numpy(), grid[:, j].max(0))
        np.testing.assert_allclose(tiles[p].numpy(),
                                   grid[i].sum(0)[:, 2 * j:2 * j + 2],
                                   rtol=1e-6)
    stacked = sharding.all_gather(parts, "cpu")
    assert np.array_equal(stacked.numpy(), np.stack(xs))
    with pytest.raises(ValueError, match="does not split"):
        sharding.psum_scatter(mesh, parts, "b", dim=0)


def test_meshes_place_positions_round_robin():
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu", "meta"])
    assert [d.type for d in mesh.devices] == ["cpu", "meta", "cpu", "meta"]
    assert mesh.describe()["shape"] == [2, 2]
    one = sharding.corpus_mesh(3, ["cpu"])
    assert one.axis_names == ("shard",) and one.size == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sharding.corpus_mesh(2)
    with pytest.raises(ValueError):
        sharding.corpus_mesh(0, ["cpu"])
