"""The port's Hopper kernels against their plain PyTorch versions on the
card. Marked ``gpu``: each test skips, from inside, when no CUDA device is
present. Imports nothing of JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b", [8, 24, 48, 100, 200])
def test_rwmd_min_cdist_matches_plain(rng, b):
    """The default (stacked) design: one launch at any b; b=200 stacks
    more live rows than one group of 128."""
    dev = _card()
    q, w, v = 4, 300, 5000
    a = torch.tensor(rng.standard_normal((q, b, w)), dtype=torch.float32,
                     device=dev)
    mask = torch.tensor(rng.random((q, b)) > 0.3, dtype=torch.float32,
                        device=dev)
    mask[:, 0] = 1.0
    mask[-1] = 0.0                            # an all-masked (filler) row
    vocab = torch.tensor(rng.standard_normal((v, w)), dtype=torch.float32,
                         device=dev)
    before = ops.rwmd_min_cdist.launches
    got = ops.rwmd_min_cdist(a, mask, vocab)
    torch.cuda.synchronize()
    assert ops.rwmd_min_cdist.launches == before + 1     # stacked: one
    want = ref.rwmd_min_cdist_ref(a, mask, vocab)
    assert torch.isinf(got[-1]).all()
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    # no query word is a vocabulary word here, so no d ~ 0 cancellation
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("log_domain", [False, True])
@pytest.mark.parametrize("v_r,length,tile", [
    (24, 28, "auto"), (48, 48, "auto"), (96, 40, "auto"),
    (24, 28, "shared")])
def test_sinkhorn_fused_matches_plain(rng, log_domain, v_r, length, tile):
    """(96, 40) takes the live-tile variant and tile="shared" the
    shared-memory one, the others the warp-per-tile one."""
    dev = _card()
    q, n, lam = 3, 700, 4.0
    m = rng.uniform(0.1, 1.5, (q, v_r, n, length))
    g = (-lam * m) if log_domain else np.exp(-lam * m)
    r = np.ones((q, v_r))
    for qi, nr in enumerate([v_r, v_r - 5, v_r // 2]):
        g[qi, nr:] = -np.inf if log_domain else 0.0
        r[qi, :nr] = rng.uniform(0.1, 1.0, nr)
        r[qi, :nr] /= r[qi, :nr].sum()
    val = np.where(rng.random((n, length)) > 0.4, rng.random((n, length)),
                   0.0)
    val[:, 0] = np.maximum(val[:, 0], 0.05)
    val[n - 30:] = 0.0                        # pad docs
    val /= np.maximum(val.sum(1, keepdims=True), 1e-9)
    gt, vt, rt = (torch.tensor(x, dtype=torch.float32, device=dev)
                  for x in (g, val, r))
    got, iters = ops.sinkhorn_fused_all_batched(
        gt, vt, rt, lam, 15, log_domain=log_domain, with_iters=True,
        tile=tile)
    torch.cuda.synchronize()
    want, want_iters = ref.sinkhorn_fused_all_batched_ref(
        gt, vt, rt, lam, 15, log_domain=log_domain)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(iters, want_iters)
    assert (got[:, n - 30:] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("v_r,w", [(5, 300), (19, 300), (43, 300),
                                   (64, 300), (200, 300), (23, 61),
                                   (70, 61)])
@pytest.mark.parametrize("mode", ["full", "k_only", "log_k"])
def test_cdist_exp_matches_plain(rng, v_r, w, mode):
    """v_r=200 runs as four row tiles, 70 as two; V=5001 is no multiple of
    the 128-row vocabulary tile; w=61 takes the 4-byte copies. The query
    words are vocabulary rows, so exact matches (d ~ 0) occur."""
    dev = _card()
    v = 5001
    vocab = torch.tensor(rng.standard_normal((v, w)), dtype=torch.float32,
                         device=dev)
    a = vocab[torch.as_tensor(rng.choice(v, v_r, replace=False),
                              device=dev)].contiguous()
    rw = rng.uniform(0.1, 1.0, v_r)
    r = torch.tensor(rw / rw.sum(), dtype=torch.float32, device=dev)
    k_only, log_k = mode != "full", mode == "log_k"
    lam = 10.0 if log_k else 1.0
    before = ops.cdist_exp.launches
    got = ops.cdist_exp(a, vocab, r, lam, k_only=k_only, log_k=log_k)
    torch.cuda.synchronize()
    assert ops.cdist_exp.launches == before + 1
    ref.hold_cdist_exp(got, a, vocab, r, lam, k_only, log_k)


def _k4_inputs(rng, dev, v_r, n, length, lam, log_domain, live_rows):
    m = rng.uniform(0.1, 1.5, (v_r, n, length))
    g = (-lam * m) if log_domain else np.exp(-lam * m)
    g[live_rows:] = -np.inf if log_domain else 0.0       # pad query rows
    r = np.ones(v_r)
    r[:live_rows] = rng.uniform(0.1, 1.0, live_rows)
    r[:live_rows] /= r[:live_rows].sum()
    val = np.where(rng.random((n, length)) > 0.4, rng.random((n, length)),
                   0.0)
    val[:, 0] = np.maximum(val[:, 0], 0.05)
    val[n - 30:] = 0.0                        # all-pad docs
    val /= np.maximum(val.sum(1, keepdims=True), 1e-9)
    return tuple(torch.tensor(x, dtype=torch.float32, device=dev)
                 for x in (g, val, r))


@pytest.mark.gpu
@pytest.mark.parametrize("log_domain", [False, True])
@pytest.mark.parametrize("v_r,length", [(24, 28), (43, 64), (96, 40)])
def test_sinkhorn_fused_all_matches_plain(rng, log_domain, v_r, length):
    """K4 (K1's kernels on an (N, 1) grid): pad query rows and all-pad
    docs are inert; (96, 40) takes the live-tile route (three launches:
    two size classes, then the pairs over the arena)."""
    dev = _card()
    n, lam = 700, 4.0
    g, val, r = _k4_inputs(rng, dev, v_r, n, length, lam, log_domain,
                           v_r - 5)
    before = ops.sinkhorn_fused_all.launches
    got, iters = ops.sinkhorn_fused_all(g, val, r, lam, 15,
                                        log_domain=log_domain,
                                        with_iters=True)
    torch.cuda.synchronize()
    assert ops.sinkhorn_fused_all.launches == \
        before + (1 if ops.fits_warp(v_r, length) else 3)
    want, want_iters = ref.sinkhorn_fused_all_ref(g, val, r, lam, 15,
                                                  log_domain=log_domain)
    torch.testing.assert_close(got, want, rtol=5e-5, atol=5e-5)
    assert torch.equal(iters, want_iters)
    assert (got[n - 30:] == 0).all()
    trimmed = ops.sinkhorn_fused_all(g[:v_r - 5].contiguous(), val,
                                     r[:v_r - 5].contiguous(), lam, 15,
                                     log_domain=log_domain)
    torch.testing.assert_close(got, trimmed, rtol=1e-6, atol=1e-6)


def _k5_inputs(rng, v_r, n, length, edge):
    """K5's inputs (as tests/test_torch_kernels.py's): "last_live" ends
    each doc's live slots at a slot drawn from 0 (all-pad) to L, with dead
    slots inside; "x_zero" zeroes whole rows and columns of x;
    "subnormal" adds to "last_live" a subnormal G column at a dead slot
    past doc n - 4's last live one, so t is subnormal there (unguarded,
    1/t overflows and w = 0 * inf = NaN); "subnormal_live" makes that slot
    live; "gr_inf" (the G/r inf is set by the test) makes doc n - 5's
    last slot dead. The first n // 8 docs are all-pad in every case."""
    g = np.abs(rng.standard_normal((v_r, n, length))) + 0.1
    val = np.abs(rng.standard_normal((n, length)))
    val = np.where(val > 0.8, val, 0.0)
    x = np.abs(rng.standard_normal((v_r, n))) + 0.5
    x[0, : n // 4] = 0.0                      # u = safe_inv(0) = 0
    if edge in ("last_live", "subnormal", "subnormal_live", "gr_inf"):
        ends = rng.integers(0, length + 1, n)
        ends[-3:] = (0, length, 1)
        for d, e in enumerate(ends):
            val[d, e:] = 0.0
            if e:
                val[d, e - 1] = 1.0 + rng.random()
    if edge == "x_zero":
        x[v_r // 2] = 0.0
        x[:, n // 2] = 0.0
        x[rng.random((v_r, n)) < 0.1] = 0.0
    if edge in ("subnormal", "subnormal_live"):
        val[n - 4, 5:] = 0.0
        g[:, n - 4, 9] = 1e-42
    if edge == "subnormal_live":
        val[n - 4, 9] = 1.5
    if edge == "gr_inf":
        val[n - 5, length - 1] = 0.0
    val[: n // 8] = 0.0                       # all-pad docs: t > 0, w = 0
    return g, val, x


@pytest.mark.gpu
@pytest.mark.parametrize("v_r,n,length,edge", [
    pytest.param(8, 128, 128, None, id="8-128-128"),
    pytest.param(19, 64, 40, None, id="19-64-40"),
    pytest.param(24, 5000, 28, None, id="24-5000-28"),
    pytest.param(3, 32, 8, None, id="3-32-8"),
    pytest.param(70, 256, 64, None, id="70-256-64"),
    pytest.param(200, 5000, 28, "last_live", id="query_200"),
    pytest.param(23, 5000, 28, "last_live", id="last_live"),
    pytest.param(23, 700, 30, "last_live", id="last_live_l30"),
    pytest.param(5, 480, 13, "last_live", id="last_live_l13"),
    pytest.param(40, 640, 28, "last_live", id="vr40"),
    pytest.param(70, 640, 36, "last_live", id="vr70_l36"),
    pytest.param(23, 640, 28, "x_zero", id="x_zero"),
    pytest.param(23, 640, 28, "subnormal", id="subnormal"),
    pytest.param(23, 640, 30, "subnormal", id="subnormal_l30"),
    pytest.param(23, 640, 28, "subnormal_live", id="subnormal_live"),
    pytest.param(23, 640, 28, "gr_inf", id="gr_inf"),
    pytest.param(40, 640, 36, "gr_inf", id="gr_inf_vr40_l36")])
def test_sddmm_spmm_step_matches_plain(rng, v_r, n, length, edge):
    """K5 at tests/test_kernels.py's shapes and tolerance, the paper's
    one-query shape and a 200-word query (seven row chunks), and the
    edges of its design: each doc's last live slot from 0 to L, L no
    multiple of 4 or over 32 (slot classes), v_r over 24, 32 and 64 (row
    chunks), zero x, all-pad docs, a subnormal t at a dead and at a live
    slot (w = 0 there, no NaN) and an inf G/r entry at a dead slot
    (inf * 0): NaN where the plain version has NaN, and only there."""
    dev = _card()
    g, val, x = (torch.tensor(t, dtype=torch.float32, device=dev)
                 for t in _k5_inputs(rng, v_r, n, length, edge))
    gor = g * 1.7
    if edge == "gr_inf":
        gor[3, n - 5, length - 1] = float("inf")
    before = ops.sddmm_spmm_step.launches
    got = ops.sddmm_spmm_step(g, gor, val, x)
    torch.cuda.synchronize()
    assert ops.sddmm_spmm_step.launches == before + 1
    want = ref.sddmm_spmm_step_ref(g, gor, val, x)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    if edge == "gr_inf":
        assert nan[3, n - 5] and int(nan.sum()) == 1
    else:
        assert not nan.any()
    torch.testing.assert_close(got[~nan], want[~nan], rtol=1e-5, atol=1e-5)
    assert (got[:, : n // 8] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["dense", "dense_stabilized", "sparse",
                                  "sparse_unfused", "kernel"])
def test_one_to_many_on_card_matches_host(impl):
    """Every impl on the card against the same impl on the host (where
    the kernel impl runs the kernels' plain versions). K3 and the host
    GEMM sum a.b in different orders, which at exact word matches moves
    the kernel impl's distances by up to 3.8e-4 relative here (ROADMAP
    queue 3, P1), so it is held at 1e-3; the others at 1e-4."""
    from repro_torch.core import one_to_many
    from repro_torch.data.corpus import make_corpus
    dev = _card()
    c = make_corpus(vocab_size=2048, embed_dim=64, n_docs=128, n_queries=2,
                    seed=3)
    for q in c.queries:
        got = one_to_many(q, c.docs, c.vecs, 1.0, 15, impl=impl, device=dev)
        want = one_to_many(q, c.docs, c.vecs, 1.0, 15, impl=impl,
                           device="cpu")
        assert got.device.type == "cuda"
        tol = 1e-3 if impl == "kernel" else 1e-4
        torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)


# K2s cases: (q, b, vc, w, filler queries, live rows per query or None for
# a random 70%); ROUTE_TILES: the 128-column tiles from which K2s takes
# the stacked kernel at q=4, b=24 (rwmd_min_cdist.cu's subset_stacked:
# q * tiles >= kStRouteTiles = 112 per group of 128 support rows)
ROUTE_TILES = 28
K2S_CASES = {
    "24-1000-300": (4, 24, 1000, 300, 1, None),
    "48-128-300": (4, 48, 128, 300, 1, None),
    "200-3000-300": (4, 200, 3000, 300, 1, None),
    "24-77-61": (4, 24, 77, 61, 1, None),
    "130-45-61": (4, 130, 45, 61, 1, None),
    "65-2048-300": (4, 65, 2048, 300, 1, None),
    "fillers6_vc50000": (16, 24, 50_000, 300, 6, None),
    "one_query_12_live_vc60000": (1, 16, 60_000, 300, 0, 12),
    "q70": (70, 24, 20_000, 300, 1, None),
    "q70_w61": (70, 24, 20_000, 61, 1, None),
    "route_below": (4, 24, 128 * (ROUTE_TILES - 1), 300, 1, None),
    "route_at": (4, 24, 128 * (ROUTE_TILES - 1) + 1, 300, 1, None),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(K2S_CASES))
def test_rwmd_min_cdist_subset_matches_plain(rng, case):
    """K2s: ids in any order, with repeats where the vocabulary is narrow
    (the reference's padding repeats vids[0]) and distinct where it is
    wide (the port's cascade passes its live words unpadded), a Vc that is
    no multiple of a column tile, all-masked filler queries, w=61 (4-byte
    copies), more than 128 support rows (b=130, 200), a one-query stage of
    12 live rows, more queries than one stacked block's 64, and a Vc on
    each side of the route's switch; one launch at every shape."""
    dev = _card()
    q, b, vc, w, fillers, live = K2S_CASES[case]
    v = max(20000, vc + 1000)
    a = torch.tensor(rng.standard_normal((q, b, w)), dtype=torch.float32,
                     device=dev)
    if live is None:
        mask = torch.tensor(rng.random((q, b)) > 0.3, dtype=torch.float32,
                            device=dev)
        mask[:, 0] = 1.0
    else:
        mask = torch.zeros((q, b), device=dev)
        mask[:, :live] = 1.0
    if fillers:
        mask[-fillers:] = 0.0                 # all-masked (filler) rows
    vocab = torch.tensor(rng.standard_normal((v, w)), dtype=torch.float32,
                         device=dev)
    ids = rng.choice(v, vc, replace=False)
    if vc <= 4096:
        ids[-vc // 4:] = ids[0]               # padded tail repeats ids[0]
    ids = torch.tensor(ids, dtype=torch.int64, device=dev)
    route = ops.rwmd_subset_route(q, b, vc)
    if case.startswith("route_"):
        assert route == ("stacked" if case == "route_at" else "per_query")
    before = ops.rwmd_min_cdist_subset.launches
    got = ops.rwmd_min_cdist(a, mask, vocab, vocab_ids=ids)
    torch.cuda.synchronize()
    assert ops.rwmd_min_cdist_subset.launches == before + 1
    assert got.shape == (q, vc)
    want = ref.rwmd_min_cdist_subset_ref(a, mask, vocab, ids)
    if fillers:
        assert torch.isinf(got[-fillers:]).all()
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)
    # the same columns as the full sweep
    full = ops.rwmd_min_cdist(a, mask, vocab)[:, ids]
    torch.testing.assert_close(got[fin], full[fin], rtol=1e-5, atol=1e-4)


def _carry_to(index, dev):
    """The same index (clusters, pivots, storage order) on another device."""
    from repro_torch.core.index import index_from_arrays
    cl = index.clusters
    arrays = {"idx": index.docs_host.idx, "val": index.docs_host.val,
              "vecs": index.vecs.cpu().numpy(),
              "centroids": index.centroids.cpu().numpy(),
              "n_groups": len(index.groups),
              "c_centers": cl.centers.cpu().numpy(), "c_assign": cl.assign,
              "c_order": cl.order, "c_starts": cl.starts,
              "c_radii": cl.radii, "ext_ids": index.ext_ids,
              "remap": index.remap, "pivots": index.pivots.cpu().numpy(),
              "doc_pivot_d": index.doc_pivot_d.cpu().numpy()}
    return index_from_arrays(arrays, device=dev)


@pytest.mark.gpu
def test_cascade_and_refine_on_card_match_host():
    """The IVF cascade and refine search on the card against the same
    calls on the host (the kernels' plain versions), over one index
    carried to both devices. The card's K block (cuBLAS) and the host's
    GEMM sum in different orders, which at the dedup corpus' exact word
    matches moves distances by ~1e-3 (ROADMAP queue 3, P1): held at the
    reference's spread, R2."""
    from repro_torch.core.index import WmdEngine, build_index
    from repro_torch.data.corpus import dedup_corpus
    dev = _card()
    c = dedup_corpus(512, vocab=4096, embed_dim=64, seed=2)
    host = build_index(c.docs, c.vecs, device="cpu", n_clusters="auto")
    card = _carry_to(host, dev)
    qs = list(c.queries)
    calls = [dict(prune=p, nprobe=npb) for p in
             ("ivf+wcd+rwmd", "ivf+pivot+wcd+rwmd", "ivf+rwmd")
             for npb in (None, 2)]
    calls += [dict(prune="ivf+pivot+wcd+rwmd", mode="refine",
                   refine_factor=rf) for rf in (1, 4)]
    for lam, precision in ((1.0, "fp32"), (10.0, "log")):
        eh = WmdEngine(host, lam=lam, n_iter=15, precision=precision)
        ec = WmdEngine(card, lam=lam, n_iter=15, precision=precision)
        for kw in calls:
            ops.reset_launches()
            got = ec.search(qs, 10, **kw)
            torch.cuda.synchronize()
            assert ops.launches()["rwmd_min_cdist_subset"] > 0, kw
            want = eh.search(qs, 10, **kw)
            np.testing.assert_array_equal(got.indices, want.indices)
            np.testing.assert_array_equal(got.solved, want.solved)
            np.testing.assert_allclose(got.distances, want.distances,
                                       rtol=1e-3, atol=5e-3)


def _cost_inputs(rng, dev, q, v_r, n, length, lam, log_domain, w=16):
    """G from Euclidean costs between random points (so the Sinkhorn
    iteration converges and documents exit at different counts), pad
    query rows in the later queries and 30 all-pad docs."""
    a = rng.standard_normal((q, v_r, w))
    b = rng.standard_normal((n, length, w))
    m = np.sqrt(((a[:, :, None, None, :] - b[None, None]) ** 2).sum(-1))
    g = (-lam * m) if log_domain else np.exp(-lam * m)
    r = np.ones((q, v_r))
    for qi, nr in enumerate([v_r, v_r - 5, v_r // 2][:q]):
        g[qi, nr:] = -np.inf if log_domain else 0.0
        r[qi, :nr] = rng.uniform(0.1, 1.0, nr)
        r[qi, :nr] /= r[qi, :nr].sum()
    val = np.where(rng.random((n, length)) > 0.4, rng.random((n, length)),
                   0.0)
    val[:, 0] = np.maximum(val[:, 0], 0.05)
    val[n - 30:] = 0.0
    val /= np.maximum(val.sum(1, keepdims=True), 1e-9)
    return tuple(torch.tensor(x, dtype=torch.float32, device=dev)
                 for x in (g, val, r))


@pytest.mark.gpu
@pytest.mark.parametrize("gemm", ["fp32", "bf16"])
@pytest.mark.parametrize("log_domain", [False, True])
@pytest.mark.parametrize("v_r,length,tile", [
    (24, 28, "auto"), (48, 48, "auto"), (96, 40, "auto"),
    (24, 28, "shared")])
def test_sinkhorn_fused_adaptive_matches_plain(rng, gemm, log_domain, v_r,
                                               length, tile):
    """K1's adaptive exit with a resmask (query 1 scoped to half its
    docs), and its bf16 operands, in both variants, against the plain
    version (ref.hold_solve: the K1 tolerance of chip_smoke.py; a doc
    whose residual came within ref.NEAR_TIE of tol may exit a window
    apart); fixed-mode bf16 too."""
    dev = _card()
    q, n, lam = 3, 700, 1.0
    g, val, r = _cost_inputs(rng, dev, q, v_r, n, length, lam, log_domain)
    rm = torch.ones((q, n), device=dev)
    rm[1, ::2] = 0.0
    for opts in (dict(tol=1e-2, check_every=2, resmask=rm),
                 dict(tol=3e-2, check_every=3), dict()):
        got, iters = ops.sinkhorn_fused_all_batched(
            g, val, r, lam, 40, log_domain=log_domain, gemm=gemm,
            with_iters=True, tile=tile, block_n=64, **opts)
        torch.cuda.synchronize()
        held = ref.hold_solve(got, iters, g, val, r, lam, 40, 1e-4, 1e-4,
                              block_n=64, log_domain=log_domain, gemm=gemm,
                              **opts)
        if opts:
            assert held["mean_doc_iters"] < 40
    assert (got[:, n - 30:] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("gemm", ["fp32", "bf16"])
@pytest.mark.parametrize("log_domain", [False, True])
def test_sinkhorn_fused_all_adaptive_matches_plain(rng, gemm, log_domain):
    """K4 with tol, a resmask and bf16 against the plain version; tol=0 at
    the cap equals fixed mode."""
    dev = _card()
    n, lam = 700, 1.0
    g, val, r = _cost_inputs(rng, dev, 1, 24, n, 28, lam, log_domain)
    g, r = g[0], r[0]
    rm = (torch.arange(n, device=dev) % 3 != 0).float()
    kw = dict(log_domain=log_domain, gemm=gemm)
    got, iters = ops.sinkhorn_fused_all(g, val, r, lam, 40, tol=1e-2,
                                        check_every=2, resmask=rm,
                                        with_iters=True, **kw)
    torch.cuda.synchronize()
    ref.hold_solve(got, iters, g, val, r, lam, 40, 5e-5, 5e-5, tol=1e-2,
                   check_every=2, resmask=rm, **kw)
    fixed = ops.sinkhorn_fused_all(g, val, r, lam, 9, **kw)
    capped, it = ops.sinkhorn_fused_all(g, val, r, lam, 9, tol=0.0,
                                        check_every=4, with_iters=True, **kw)
    assert (it == 9).all()
    torch.testing.assert_close(capped, fixed, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("v_r,w", [(5, 300), (43, 300), (200, 300),
                                   (23, 61), (70, 61)])
@pytest.mark.parametrize("mode", ["full", "k_only", "log_k"])
def test_cdist_exp_bf16_matches_plain(rng, v_r, w, mode):
    """K3's bf16 operands against the plain version, held in squared
    distance as the fp32 kernel is (ref.hold_cdist_exp, P1), at the fp32
    test's edges."""
    dev = _card()
    v = 5001
    vocab = torch.tensor(rng.standard_normal((v, w)), dtype=torch.float32,
                         device=dev)
    a = vocab[torch.as_tensor(rng.choice(v, v_r, replace=False),
                              device=dev)].contiguous()
    rw = rng.uniform(0.1, 1.0, v_r)
    r = torch.tensor(rw / rw.sum(), dtype=torch.float32, device=dev)
    k_only, log_k = mode != "full", mode == "log_k"
    lam = 10.0 if log_k else 1.0
    before = ops.cdist_exp.launches
    got = ops.cdist_exp(a, vocab, r, lam, k_only=k_only, log_k=log_k,
                        gemm="bf16")
    torch.cuda.synchronize()
    assert ops.cdist_exp.launches == before + 1
    ref.hold_cdist_exp(got, a, vocab, r, lam, k_only, log_k, gemm="bf16")


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["fp32", "bf16", "bf16+log"])
def test_adaptive_search_on_card_matches_host(precision):
    """The adaptive search on the card against the same calls on the host,
    over one index carried to both devices: the top-10 sets, solved counts
    and per-query realized counts equal, distances at the reference's
    spread R2 (the K blocks' GEMMs differ, P1, which can swap the order
    of a near-tie pair under bf16)."""
    from repro_torch.core.index import WmdEngine, build_index
    from repro_torch.data.corpus import dedup_corpus
    dev = _card()
    c = dedup_corpus(512, vocab=4096, embed_dim=64, seed=2)
    host = build_index(c.docs, c.vecs, device="cpu", n_clusters="auto")
    card = _carry_to(host, dev)
    qs = list(c.queries)
    for scope in ("query", "chunk"):
        kw = dict(lam=0.25, n_iter=15, tol=3e-2, check_every=2,
                  scope=scope, precision=precision)
        eh, ec = WmdEngine(host, **kw), WmdEngine(card, **kw)
        for prune in ("rwmd", "ivf+wcd+rwmd"):
            got = ec.search(qs, 10, prune=prune)
            want = eh.search(qs, 10, prune=prune)
            np.testing.assert_array_equal(np.sort(got.indices, axis=1),
                                          np.sort(want.indices, axis=1))
            np.testing.assert_array_equal(got.solved, want.solved)
            np.testing.assert_allclose(got.distances, want.distances,
                                       rtol=1e-3, atol=5e-3)
        np.testing.assert_array_equal(ec.iter_stats(), eh.iter_stats())


@pytest.mark.gpu
@pytest.mark.parametrize("v_r", [7, 23, 40])
@pytest.mark.parametrize("bv,bn", [(128, 128), (64, 64), (64, 32)])
def test_bsr_sddmm_matches_plain(rng, v_r, bv, bn):
    """K6 through both entry points (``bsr_sddmm``'s gather in the load and
    the given panels) against its plain version at the reference's 1e-5
    of |c| (|kt| |u|); V and N not whole tiles; v_r = 40 takes two chunks
    of the staged product; pad tiles come out zero."""
    from repro_torch.core.sparse import block_sparse_from_dense
    dev = _card()
    v, n = 3000, 700
    c = np.where(rng.random((v, n)) < 2e-3, rng.random((v, n)), 0.0)
    cd = torch.tensor(c, dtype=torch.float32, device=dev)
    live = block_sparse_from_dense(cd, bv, bn).blocks.shape[0]
    cb = block_sparse_from_dense(cd, bv, bn, pad_blocks_to=live + 3)
    kt = torch.tensor(rng.standard_normal((v, v_r)), dtype=torch.float32,
                      device=dev)
    u = torch.tensor(rng.standard_normal((v_r, n)), dtype=torch.float32,
                     device=dev)
    before = ops.bsr_sddmm_blocks.launches
    got = ops.bsr_sddmm(kt, u, cb)
    torch.cuda.synchronize()
    assert ops.bsr_sddmm_blocks.launches == before + 1
    ktb, ub = ref.bsr_panels(kt, u, cb.brow, cb.bcol, bv, bn)
    ktb, ub = ktb.contiguous(), ub.contiguous()
    ref.hold_bsr_sddmm(got, ktb, ub, cb.blocks)
    assert (got[live:] == 0).all()
    got_b = ops.bsr_sddmm_blocks(ktb, ub, cb.blocks)
    torch.cuda.synchronize()
    ref.hold_bsr_sddmm(got_b, ktb, ub, cb.blocks)
    torch.testing.assert_close(got, ref.bsr_sddmm_ref(kt, u, cb), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("gemm", ["fp32", "bf16"])
@pytest.mark.parametrize("log_domain", [False, True])
@pytest.mark.parametrize("tol", [None, 3e-2])
def test_sinkhorn_fused_over_the_smem_limit_matches_plain(rng, gemm,
                                                          log_domain, tol):
    """A (256, 256) tile needs 263 KB of shared memory, over the card's 227
    KB: the shared variant is refused by name; ``tile="auto"`` takes the
    live-tile variant, which streams the pairs whose live tile is over its
    arena from device memory, and ``tile="global"`` reads every pair
    there: both held against the plain version, fixed and adaptive, for
    K1 and for K4 on one query's tile."""
    dev = _card()
    lam = 10.0 if log_domain else 1.0
    g, val, r = _cost_inputs(rng, dev, 2, 256, 96, 256, lam, log_domain)
    kw = dict(log_domain=log_domain, gemm=gemm)
    if tol is not None:
        kw.update(tol=tol, check_every=2)
    with pytest.raises(ValueError, match="shared memory"):
        ops.sinkhorn_fused_all_batched(g, val, r, lam, 15, tile="shared",
                                       **kw)
    for tile in ("auto", "global"):
        got, iters = ops.sinkhorn_fused_all_batched(
            g, val, r, lam, 15, with_iters=True, tile=tile, **kw)
        torch.cuda.synchronize()
        ref.hold_solve(got, iters, g, val, r, lam, 15, 1e-4, 1e-4, **kw)
    # K4 (K1's entry point at Q = 1) takes the same variant
    got4, it4 = ops.sinkhorn_fused_all(g[0], val, r[0], lam, 15,
                                       with_iters=True, **kw)
    torch.cuda.synchronize()
    ref.hold_solve(got4, it4, g[0], val, r[0], lam, 15, 1e-4, 1e-4, **kw)


@pytest.mark.gpu
def test_einsum_engine_and_kcache_on_card():
    """The einsum engine on the card against the same calls on the host
    (P1 between the card's and the host's GEMMs: R2), and on the card the
    K-column cache's results equal the uncached engine's bit for bit, cold
    and warm, in every precision."""
    from repro_torch.core.index import WmdEngine, build_index
    from repro_torch.data.corpus import dedup_corpus
    dev = _card()
    c = dedup_corpus(512, vocab=4096, embed_dim=64, seed=2)
    host = build_index(c.docs, c.vecs, device="cpu", n_clusters="auto")
    card = _carry_to(host, dev)
    qs = list(c.queries)
    kw = dict(lam=0.25, n_iter=15, tol=3e-2, check_every=2, impl="sparse",
              warm_start=True)
    eh, ec = WmdEngine(host, **kw), WmdEngine(card, **kw)
    for prune in ("rwmd", "ivf+wcd+rwmd"):
        got, want = ec.search(qs, 10, prune=prune), eh.search(qs, 10,
                                                              prune=prune)
        np.testing.assert_array_equal(np.sort(got.indices, axis=1),
                                      np.sort(want.indices, axis=1))
        np.testing.assert_allclose(got.distances, want.distances, rtol=1e-3,
                                   atol=5e-3)
    for precision in ("fp32", "bf16", "log", "bf16+log"):
        off = WmdEngine(card, lam=1.0, n_iter=15, impl="sparse",
                        precision=precision)
        on = WmdEngine(card, lam=1.0, n_iter=15, impl="sparse",
                       precision=precision, kcache_slots=64,
                       kcache_min_hits=1)
        for _ in ("cold", "warm"):
            a, b = off.search(qs, 10, prune="rwmd"), on.search(qs, 10,
                                                                prune="rwmd")
            np.testing.assert_array_equal(a.indices, b.indices)
            np.testing.assert_array_equal(a.distances, b.distances)
            np.testing.assert_array_equal(off.query_batch(qs).numpy(),
                                          on.query_batch(qs).numpy())
        assert on.kcache_stats()["hits"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("q,b,v,w", [(4, 19, 5003, 300), (4, 24, 5003, 300),
                                     (2, 200, 5003, 300),
                                     (16, 48, 3000, 300), (3, 24, 1000, 61),
                                     (65, 19, 5003, 300),
                                     (130, 24, 3000, 300)])
def test_rwmd_min_cdist_designs_match_plain(rng, q, b, v, w):
    """K2's stacked-query kernel: live rows that straddle queries (b of 19
    and 24 put two queries' rows in one 8-row group), an all-masked query, more
    live rows than one stacked group (b = 200), a ragged V, w = 61 (not a
    multiple of 4: the stacked kernel's 4-byte copies), and more queries
    than one stacked block serves (65 and 130: a block row per 64 queries,
    one launch). The query
    words are vocabulary rows, so exact matches (d ~ 0) occur: held in
    squared distance at chip_smoke.py's K2_SQ_RTOL."""
    dev = _card()
    vocab = torch.tensor(rng.standard_normal((v, w)), dtype=torch.float32,
                         device=dev)
    sup = torch.as_tensor(rng.choice(v, (q, b)), device=dev)
    a = vocab[sup].contiguous()
    mask = torch.tensor(rng.random((q, b)) > 0.25, dtype=torch.float32,
                        device=dev)
    mask[:, 0] = 1.0
    mask[1] = 0.0                             # an all-masked query
    before = ops.rwmd_min_cdist.launches
    got = ops.rwmd_min_cdist(a, mask, vocab)
    torch.cuda.synchronize()
    assert ops.rwmd_min_cdist.launches == before + 1
    want = ref.rwmd_min_cdist_ref(a, mask, vocab)
    assert torch.isinf(got[1]).all()
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    fin = torch.isfinite(want)
    a2 = torch.where(mask > 0, (a * a).sum(-1), torch.zeros_like(mask))
    scale = a2.max(dim=1).values[:, None] + (vocab * vocab).sum(-1)[None]
    err = (got * got - want * want).abs()
    assert (err[fin] <= 1e-5 * scale[fin]).all()


def _euclid_inputs(rng, dev, q, v_r, n, length, lam, log_domain, w=16):
    """As :func:`_cost_inputs`, with the distances from one product (the
    tiles up to 64 x 64 would not fit the broadcast)."""
    a = rng.standard_normal((q, v_r, w))
    b = rng.standard_normal((n, length, w))
    d2 = ((a * a).sum(-1)[:, :, None, None] + (b * b).sum(-1)[None, None]
          - 2.0 * np.einsum("qkw,nlw->qknl", a, b))
    m = np.sqrt(np.maximum(d2, 0.0))
    g = (-lam * m) if log_domain else np.exp(-lam * m)
    r = np.ones((q, v_r))
    for qi, nr in enumerate([v_r, v_r - 5, v_r // 2][:q]):
        g[qi, nr:] = -np.inf if log_domain else 0.0
        r[qi, :nr] = rng.uniform(0.1, 1.0, nr)
        r[qi, :nr] /= r[qi, :nr].sum()
    val = np.where(rng.random((n, length)) > 0.4, rng.random((n, length)),
                   0.0)
    val[:, 0] = np.maximum(val[:, 0], 0.05)
    val[::3] = 0.0                            # a third of the docs inert
    val /= np.maximum(val.sum(1, keepdims=True), 1e-9)
    return tuple(torch.tensor(x, dtype=torch.float32, device=dev)
                 for x in (g, val, r))


@pytest.mark.gpu
@pytest.mark.parametrize("gemm", ["fp32", "bf16"])
@pytest.mark.parametrize("log_domain", [False, True])
@pytest.mark.parametrize("v_r,length", [(24, 28), (32, 32), (48, 48),
                                        (64, 64), (40, 13)])
def test_sinkhorn_fused_warp_matches_plain(rng, gemm, log_domain, v_r,
                                           length):
    """K1's warp-per-tile design (tile="warp", and "auto"): N = 701, not a
    multiple of the docs a block holds; a third of the docs inert (their
    solve is skipped: distance 0, the count of ref.inert_doc_iters);
    fixed and adaptive with a resmask, fp32 and bf16, linear and log,
    against the plain version (ref.hold_solve); fixed-mode counts equal.
    L = 13 takes the 4-byte copies. tile="registers" is an alias of
    "warp"."""
    dev = _card()
    q, n, lam = 3, 701, 1.0
    g, val, r = _euclid_inputs(rng, dev, q, v_r, n, length, lam, log_domain)
    rm = torch.ones((q, n), device=dev)
    rm[1, 1::2] = 0.0
    for opts in (dict(), dict(tol=1e-2, check_every=2, resmask=rm),
                 dict(tol=3e-2, check_every=3)):
        want_idle = ref.inert_doc_iters(30, opts.get("tol"),
                                        opts.get("check_every", 4))
        for tile in ("warp", "registers", "auto"):
            got, iters = ops.sinkhorn_fused_all_batched(
                g, val, r, lam, 30, log_domain=log_domain, gemm=gemm,
                with_iters=True, tile=tile, block_n=64, **opts)
            torch.cuda.synchronize()
            ref.hold_solve(got, iters, g, val, r, lam, 30, 1e-4, 1e-4,
                           block_n=64, log_domain=log_domain, gemm=gemm,
                           **opts)
            assert (got[:, ::3] == 0).all()
            if not opts:
                assert (iters == 30).all()
            one, it1 = ops.sinkhorn_fused_all_batched(
                g, val, r, lam, 30, log_domain=log_domain, gemm=gemm,
                with_iters=True, tile=tile, block_n=1, **opts)
            assert (it1[:, ::3] == want_idle).all()
            assert torch.equal(one, got)


@pytest.mark.gpu
def test_sinkhorn_fused_warp_refuses_wide_tiles(rng):
    dev = _card()
    g, val, r = _euclid_inputs(rng, dev, 1, 65, 8, 16, 1.0, False)
    with pytest.raises(ValueError, match="64 x 64"):
        ops.sinkhorn_fused_all_batched(g, val, r, 1.0, 5, tile="warp")


def _live_inputs(rng, dev, q, v_r, n, length, lam, log_domain, w=16):
    """Tiles past 64 x 64 for K1's live-tile kernel: Euclidean costs
    (float64 on the card), queries of v_r, v_r - 5 and v_r // 2 live rows
    and then a filler (no live row, r 1); documents of every live length
    from 1 to L, every fifth with a run of zeros before its last live
    words (not front-compacted), every seventh inert (val all zero)."""
    a = torch.tensor(rng.standard_normal((q, v_r, w)), dtype=torch.float64,
                     device=dev)
    b = torch.tensor(rng.standard_normal((n, length, w)),
                     dtype=torch.float64, device=dev)
    d2 = ((a * a).sum(-1)[:, :, None, None] + (b * b).sum(-1)[None, None]
          - 2.0 * torch.einsum("qkw,nlw->qknl", a, b))
    m = d2.clamp(min=0.0).sqrt()
    g = (-lam * m) if log_domain else torch.exp(-lam * m)
    r = np.ones((q, v_r))
    for qi, nr in enumerate([v_r, v_r - 5, v_r // 2, 0][:q]):
        g[qi, nr:] = -float("inf") if log_domain else 0.0
        if nr:
            r[qi, :nr] = rng.uniform(0.1, 1.0, nr)
            r[qi, :nr] /= r[qi, :nr].sum()
    ext = rng.integers(1, length + 1, n)
    ext[:3] = (length, 1, length // 2)
    slots = np.arange(length)[None]
    val = np.where((slots < ext[:, None]) & (rng.random((n, length)) > 0.3),
                   rng.random((n, length)) + 0.05, 0.0)
    val[np.arange(n), ext - 1] = 0.5              # the last live slot
    for j in range(0, n, 5):
        val[j, :ext[j] // 2] = 0.0
    val[::7] = 0.0
    val /= np.maximum(val.sum(1, keepdims=True), 1e-9)
    return (g.to(torch.float32).contiguous(),
            torch.tensor(val, dtype=torch.float32, device=dev),
            torch.tensor(r, dtype=torch.float32, device=dev))


def _live_cells(g, val, log_domain):
    """(on-chip, streamed) live cells of the live-tile kernel's rule:
    a pair's rows to its last row with a live entry (G != 0, or finite
    under the log domain) on its slots to its last val != 0, solved on
    chip where ops.live_tile_bytes fits ops.LIVE_ARENA_BYTES."""
    nz = val.ne(0)
    ext = torch.where(nz.any(1), nz.shape[1] - nz.flip(1).int().argmax(1),
                      torch.zeros_like(nz[:, 0], dtype=torch.long))
    live = torch.isfinite(g) if log_domain else g.ne(0)
    inside = torch.arange(g.shape[3], device=g.device) < ext[:, None]
    rows = (live & inside[None, None]).any(3)              # (Q, v_r, N)
    k = torch.where(rows.any(1), rows.shape[1]
                    - rows.flip(1).int().argmax(1), 0)      # (Q, N)
    onchip = streamed = 0
    for kk, e in zip(k.flatten().tolist(), ext.repeat(g.shape[0]).tolist()):
        if ops.live_tile_bytes(kk, e) <= ops.LIVE_ARENA_BYTES:
            onchip += kk * e
        else:
            streamed += kk * e
    return onchip, streamed


@pytest.mark.gpu
@pytest.mark.parametrize("gemm", ["fp32", "bf16"])
@pytest.mark.parametrize("log_domain", [False, True])
@pytest.mark.parametrize("v_r,n,length", [(96, 701, 80), (200, 257, 150),
                                          (40, 301, 100), (256, 96, 256)])
def test_sinkhorn_fused_live_matches_plain(rng, gemm, log_domain, v_r, n,
                                           length):
    """K1's live-tile route (what tile="auto" runs past 64 x 64)
    on documents of every live length from 1 to L, some not
    front-compacted and some inert, pad query rows and a filler query,
    N not a multiple of block_n: fixed, adaptive with a resmask and
    adaptive, against the plain version (ref.hold_solve) and, fixed,
    against tile="global"; K4 on the first query's tile. At (256, 96,
    256) the longest documents' live tiles are over the arena and
    stream, the others are solved on chip, in one launch. The kernel's
    count of on-chip and streamed cells equals ops.live_tile_bytes'
    rule, and that rule the kernel's own."""
    dev = _card()
    lam = 10.0 if log_domain else 1.0
    q = 4
    g, val, r = _live_inputs(rng, dev, q, v_r, n, length, lam, log_domain)
    rm = torch.ones((q, n), device=dev)
    rm[1, 1::2] = 0.0
    kw = dict(log_domain=log_domain, gemm=gemm)
    for opts in (dict(), dict(tol=1e-2, check_every=2, resmask=rm),
                 dict(tol=3e-2, check_every=3)):
        got, iters = ops.sinkhorn_fused_all_batched(
            g, val, r, lam, 15, with_iters=True, block_n=64, **kw, **opts)
        torch.cuda.synchronize()
        ref.hold_solve(got, iters, g, val, r, lam, 15, 1e-4, 1e-4,
                       block_n=64, **kw, **opts)
        # the same bits again: pairs pack into other blocks and rounds
        # from call to call, and a pair's sums do not depend on its packing
        again = ops.sinkhorn_fused_all_batched(g, val, r, lam, 15, **kw,
                                               **opts)
        torch.testing.assert_close(again, got, rtol=0, atol=0,
                                   equal_nan=True)
        assert (got[:, ::7] == 0).all()
        if not opts:
            glob, git = ops.sinkhorn_fused_all_batched(
                g, val, r, lam, 15, with_iters=True, block_n=64,
                tile="global", **kw)
            torch.testing.assert_close(got, glob, rtol=1e-4, atol=1e-4,
                                       equal_nan=True)
            assert torch.equal(iters, git)
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    ops._solve_launch(ops.sinkhorn_fused_all_batched, g, val, r, None, lam,
                      15, 128, None, 4, gemm, log_domain, "auto", q, v_r, n,
                      length, False, stats=stats)
    torch.cuda.synchronize()
    assert tuple(stats.tolist()) == _live_cells(g, val, log_domain)
    lib = ops._lib()
    for k, length_ in ((1, 1), (v_r, length), (33, 65), (255, 257)):
        assert ops.live_tile_bytes(k, length_) == \
            4 * lib.sinkhorn_fused_live_floats(k, length_)
    got4, it4 = ops.sinkhorn_fused_all(g[0], val, r[0], lam, 15,
                                       with_iters=True, **kw)
    torch.cuda.synchronize()
    ref.hold_solve(got4, it4, g[0], val, r[0], lam, 15, 1e-4, 1e-4, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("prune", [None, "rwmd"])
def test_live_tile_engine_on_card_matches_host(prune):
    """The kernel engine at news20's widths (documents of 1 to 300
    distinct words, queries of 20 to 280, four doc groups, log domain at
    lam=10) on the card, where K1 runs its live-tile kernel past 64 x 64
    (the longest pairs streamed), against the same index on the host (the
    plain version): ids equal, distances at the reference's spread R2
    (the K blocks' GEMMs differ, P1)."""
    from repro_torch.core.index import WmdEngine, build_index
    from repro_torch.core.sparse import padded_docs_from_lists
    dev = _card()
    rng = np.random.default_rng(20)
    vocab = 4096
    lens = np.concatenate([[300, 280, 1], rng.integers(1, 301, 253)])
    ids = [np.sort(rng.choice(vocab, n, replace=False)) for n in lens]
    docs = padded_docs_from_lists(ids, [rng.random(n) + 0.1 for n in lens])
    queries = np.zeros((9, vocab), np.float32)
    for q, n in enumerate((280, 250, 140, 120, 90, 70, 60, 30, 20)):
        queries[q, rng.choice(vocab, n, replace=False)] = rng.random(n) + .1
    vecs = rng.standard_normal((vocab, 32)).astype(np.float32) / 4.0
    host = build_index(docs, vecs, device="cpu", doc_groups=4)
    card = _carry_to(host, dev)
    kw = dict(lam=10.0, n_iter=15, precision="log")
    ec, eh = WmdEngine(card, **kw), WmdEngine(host, **kw)
    qs = list(queries)
    ops.reset_launches()
    got = ec.search(qs, 10, prune=prune)
    torch.cuda.synchronize()
    assert ops.launches()["sinkhorn_fused_all_batched"] > 0
    want = eh.search(qs, 10, prune=prune)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.solved, want.solved)
    np.testing.assert_allclose(got.distances, want.distances, rtol=1e-3,
                               atol=5e-3)


# ----------------------------------------------------------------- serving
def _serving_world(dev):
    """A small corpus on the card, its queries, and a request stream of
    16 draws over them (the paper's widths are chip_smoke.py's)."""
    from repro_torch.core.index import build_index
    from repro_torch.data.corpus import make_corpus
    c = make_corpus(vocab_size=2048, embed_dim=64, n_docs=512, n_queries=6,
                    seed=3)
    index = build_index(c.docs, c.vecs, device=dev)
    qids = np.random.default_rng(0).integers(0, len(c.queries), 16)
    return c, index, [c.queries[i] for i in qids], qids


def _open_loop(engine, stream, **kw):
    from repro_torch.runtime.serving import (ServeConfig, ServingRuntime,
                                             poisson_arrivals,
                                             run_open_loop)
    injector = kw.pop("injector", None)
    cfg = ServeConfig(**{**dict(max_batch=4, window_s=0.02, max_queue=1024,
                                deadline_s=None), **kw})
    runtime = ServingRuntime(engine, cfg, injector=injector)
    return run_open_loop(runtime, stream,
                         poisson_arrivals(len(stream), 100.0, seed=1),
                         k=10, deadline_s=None)


@pytest.mark.gpu
def test_serving_runtime_on_card_matches_search():
    """The runtime over the kernel engine on the card: every response is
    exact and equals ``engine.search`` of its own dispatch's batch
    replayed (ids equal, distances at rtol 1e-5); K1 and K2s ran in the
    dispatches. Against one search of all the queries (other chunk
    shapes, so cuBLAS sums the K block in another order: P1, 5.7e-5
    measured here) the distances hold at chip_smoke.py's P1_RTOL, 4e-4,
    and the ids where neighbours lie further apart than that."""
    from repro_torch.core.index import WmdEngine
    dev = _card()
    c, index, stream, qids = _serving_world(dev)
    eng = WmdEngine(index, lam=1.0, n_iter=15)
    want = eng.search(list(c.queries), 10, prune="ivf+wcd+rwmd")
    torch.cuda.synchronize()
    ops.reset_launches()
    resps, stats = _open_loop(eng, stream)
    launches = ops.launches()
    assert launches["sinkhorn_fused_all_batched"] > 0
    assert launches["rwmd_min_cdist_subset"] > 0
    assert stats["tiers"]["exact"] == len(stream)
    batches = {}
    for r in resps:
        assert r.ok and r.exact and r.tier == "exact"
        batches.setdefault(r.dispatch_id, []).append(r.rid)
    for rids in batches.values():
        rids = sorted(rids)
        res = eng.search([stream[i] for i in rids], 10,
                         prune="ivf+wcd+rwmd")
        for j, rid in enumerate(rids):
            assert resps[rid].indices == res.indices[j].tolist()
            np.testing.assert_allclose(resps[rid].distances,
                                       res.distances[j], rtol=1e-5, atol=0)
    for r, qi in zip(resps, qids):
        d = want.distances[qi]
        np.testing.assert_allclose(r.distances, d, rtol=4e-4, atol=0)
        apart = np.diff(d) > 2 * 4e-4 * d[1:]
        for j in range(10):
            if (j == 0 or apart[j - 1]) and (j == 9 or apart[j]):
                assert r.indices[j] == want.indices[qi, j]


@pytest.mark.gpu
def test_serving_faults_on_card():
    """Injected transients, latency and poison on the card: exactly the
    poisoned rids fail as ``poison``, every other response is answered,
    and the guard retried."""
    from repro_torch.core.index import WmdEngine
    from repro_torch.runtime.serving import FaultInjector
    dev = _card()
    _, index, stream, _ = _serving_world(dev)
    kw = dict(transient_rate=0.3, poison_rate=0.2, latency_rate=0.2,
              latency_s=0.01, seed=7)
    poisoned = {rid for rid in range(len(stream))
                if FaultInjector(**kw).poison(rid)}
    assert poisoned
    resps, stats = _open_loop(WmdEngine(index, lam=1.0, n_iter=15), stream,
                              injector=FaultInjector(**kw))
    for r in resps:
        if r.rid in poisoned:
            assert not r.ok and r.error["code"] == "poison"
        else:
            assert r.ok, r.error
    assert stats["retries"] > 0


@pytest.mark.gpu
def test_serving_lam_underflow_on_card():
    """fp32 at lam=50 underflows K on the card: every response is a
    structured ``lam_underflow`` with its diagnostics, from the card's
    own LamUnderflowError through the guard."""
    from repro_torch.core.index import WmdEngine
    dev = _card()
    _, index, stream, _ = _serving_world(dev)
    resps, stats = _open_loop(WmdEngine(index, lam=50.0, n_iter=5),
                              stream[:6])
    for r in resps:
        assert not r.ok and r.error["code"] == "lam_underflow"
        assert r.error["diagnostics"]
    assert stats["isolations"] >= 1


# ------------------------------------------------------------- the shards
@pytest.mark.gpu
def test_sharded_search_on_card():
    """Two shards on ``corpus_mesh(2)`` (every shard on the card when the
    host has one): full coverage, K1 and K2s launched by each shard
    (the sharded search's launches are the shards' sum), one all_gather
    per merge, and the top-10 of the single engine on the card (distances
    at chip_smoke.py's P1_RTOL, 4e-4: each shard stages its own chunks,
    so cuBLAS sums their K blocks in another order; ids where neighbours
    lie further apart). Then the same shards carried to the host search
    like the card (R2: the host GEMM sums in another order again)."""
    from repro_torch.core.index import WmdEngine, build_index, index_to_device
    from repro_torch.core.shard_index import ShardedWmdEngine, shard_corpus
    from repro_torch.data.corpus import make_corpus
    from repro_torch.runtime.sharding import corpus_mesh, count_collectives
    dev = _card()
    c = make_corpus(vocab_size=4096, embed_dim=64, n_docs=600, n_queries=6,
                    seed=3)
    qs = list(c.queries)
    mesh = corpus_mesh(2)
    assert all(d.type == "cuda" for d in mesh.devices)
    sindex = shard_corpus(c.docs, c.vecs, 2, devices=mesh)
    eng = ShardedWmdEngine(sindex, lam=1.0, n_iter=15)
    names = ("sinkhorn_fused_all_batched", "rwmd_min_cdist_subset")
    per = []
    for e in eng.engines:
        torch.cuda.synchronize()
        ops.reset_launches()
        e.search(qs, 10, prune="ivf+wcd+rwmd")
        torch.cuda.synchronize()
        per.append(ops.launches())
    ops.reset_launches()
    out = {}
    colls = count_collectives(lambda: out.setdefault(
        "res", eng.search(qs, 10, prune="ivf+wcd+rwmd")))
    torch.cuda.synchronize()
    total = ops.launches()
    assert colls == {"all_gather": 1}
    assert eng.last_coverage.full
    for n in names:
        assert all(p[n] > 0 for p in per)
        assert total[n] == sum(p[n] for p in per)
    res = out["res"]
    want = WmdEngine(build_index(c.docs, c.vecs, device=dev), lam=1.0,
                     n_iter=15).search(qs, 10, prune="ivf+wcd+rwmd")
    np.testing.assert_allclose(res.distances, want.distances, rtol=4e-4,
                               atol=0)
    for qi in range(len(qs)):
        d = want.distances[qi]
        apart = np.diff(d) > 2 * 4e-4 * d[1:]
        for j in range(10):
            if (j == 0 or apart[j - 1]) and (j == 9 or apart[j]):
                assert res.indices[qi, j] == want.indices[qi, j]
    host = ShardedWmdEngine(sindex._replace(
        shards=tuple(index_to_device(ix, "cpu") for ix in sindex.shards),
        centers=sindex.centers.cpu(),
        mesh=corpus_mesh(2, ["cpu"])), lam=1.0, n_iter=15)
    got = host.search(qs, 10, prune="ivf+wcd+rwmd")
    np.testing.assert_allclose(got.distances, res.distances, rtol=1e-3,
                               atol=5e-3)


@pytest.mark.gpu
def test_merge_on_card_equals_host(rng):
    """The one-collective merge with its shard lanes on the card: the
    all_gather to the card and the stable top-k there give the host's
    result exactly (ties to the lowest shard-major index, +inf pads
    last)."""
    from repro_torch.core.shard_index import merge_topk
    dev = _card()
    s, q, k = 4, 8, 10
    lanes = []
    for _ in range(s):
        d = np.round(rng.random((q, k)) * 4) / 4     # many exact ties
        d[:, -2:] = np.inf
        d.sort(axis=1)
        ids = rng.integers(0, 10_000, (q, k)).astype(np.float32)
        ids[:, -2:] = -1.0
        lanes.append(np.concatenate([d, ids], axis=1).astype(np.float32))
    got = merge_topk([torch.as_tensor(x, device=dev) for x in lanes], k,
                     dev)
    want = merge_topk([torch.as_tensor(x) for x in lanes], k, "cpu")
    assert got[0].device.type == "cuda"
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.gpu
def test_kernels_launched_from_threads_on_card(rng):
    """K2s and K1 launched from four host threads at once (the sharded
    fan-out's pool): each result equals its plain version and no launch
    is lost from the counters."""
    import threading
    dev = _card()
    n_threads, reps = 4, 5
    q, b, w, v, vc = 2, 16, 300, 4096, 512
    inputs = []
    for _ in range(n_threads):
        a = torch.tensor(rng.standard_normal((q, b, w)), dtype=torch.float32,
                         device=dev)
        mask = torch.ones((q, b), device=dev)
        vocab = torch.tensor(rng.standard_normal((v, w)),
                             dtype=torch.float32, device=dev)
        ids = torch.tensor(rng.choice(v, vc, replace=False), device=dev)
        g = torch.tensor(np.exp(-rng.uniform(0.1, 1.5, (q, 24, 300, 28))),
                         dtype=torch.float32, device=dev)
        val = torch.tensor(rng.random((300, 28)), dtype=torch.float32,
                           device=dev)
        val /= val.sum(1, keepdim=True)
        r = torch.full((q, 24), 1.0 / 24, device=dev)
        inputs.append((a, mask, vocab, ids, g, val, r))
    torch.cuda.synchronize()
    ops.reset_launches()
    out = [None] * n_threads
    start = threading.Barrier(n_threads)

    def work(i):
        a, mask, vocab, ids, g, val, r = inputs[i]
        start.wait()
        for _ in range(reps):
            k2s = ops.rwmd_min_cdist_subset(a, mask, vocab, ids)
            k1 = ops.sinkhorn_fused_all_batched(g, val, r, 2.0, 15)
        torch.cuda.synchronize()
        out[i] = (k2s, k1)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    counts = ops.launches()
    assert counts["rwmd_min_cdist_subset"] == n_threads * reps
    assert counts["sinkhorn_fused_all_batched"] == n_threads * reps
    for (a, mask, vocab, ids, g, val, r), (k2s, k1) in zip(inputs, out):
        want = ref.rwmd_min_cdist_subset_ref(a, mask, vocab, ids)
        torch.testing.assert_close(k2s, want, rtol=1e-5, atol=1e-4)
        want1, _ = ref.sinkhorn_fused_all_batched_ref(g, val, r, 2.0, 15)
        torch.testing.assert_close(k1, want1, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- LM decode
def _lm_pair(arch: str, router=None):
    """A reduced LM on the host and a copy of it on the card."""
    import copy
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import Transformer
    dev = _card()
    cfg = get_config(arch).reduced()
    if router:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, router=router))
    host = Transformer(cfg, 0, device="cpu")
    return host, copy.deepcopy(host).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,router", [
    ("granite_3_2b", None), ("qwen2_moe_a2_7b", "sinkhorn"),
    ("qwen2_moe_a2_7b", "topk"), ("musicgen_large", None),
    ("rwkv6_3b", None), ("zamba2_7b", None), ("qwen2_5_14b", None),
    ("phi3_medium_14b", None), ("chameleon_34b", None),
    ("nemotron_4_340b", None), ("qwen3_moe_235b_a22b", None)])
def test_lm_decode_on_card_matches_host(arch, router):
    """8 greedy serve steps at B=4: equal tokens, logits within 1e-4. All
    ten archs (qwen3_moe with its config's router and no shared expert)."""
    from repro_torch.models.model import make_serve_step
    host, card = _lm_pair(arch, router)
    out = []
    with torch.inference_mode():
        for model in (host, card):
            step = make_serve_step(model)
            cache = model.init_cache(4, 8)
            tok = torch.ones((4, 1), dtype=torch.long,
                             device=model.embed.device)
            toks, logits = [], []
            for _ in range(8):
                tok, lg, cache = step(cache, tok)
                toks.append(tok.cpu())
                logits.append(lg.cpu())
            out.append((torch.cat(toks, 1), torch.stack(logits, 1)))
    assert torch.equal(out[0][0], out[1][0])
    torch.testing.assert_close(out[1][1], out[0][1], rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_lm_prefill_matches_decode_on_card():
    """The serve-path invariant on the card at the reference's 2e-3."""
    _, card = _lm_pair("granite_3_2b")
    cfg = card.cfg
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 8)), device=card.embed.device)
    with torch.inference_mode():
        hidden, _ = card(tokens)
        full = torch.nn.functional.linear(hidden, card.lm_head_matrix())
        cache = card.init_cache(2, 8)
        dec = torch.stack([card.decode_step(cache, tokens[:, t:t + 1])[0]
                           for t in range(8)], 1)
    torch.testing.assert_close(dec, full[..., :cfg.vocab_size], rtol=2e-3,
                               atol=2e-3)


@pytest.mark.gpu
def test_serve_arch_cli_on_card():
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    _card()
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root / "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2_moe_a2_7b", "--reduced", "--steps", "6"],
        env=env, cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["device"] == torch.cuda.get_device_name(0)
    assert rec["steps"] == 6 and rec["tokens_per_s"] > 0
