"""Index snapshots and the sharded engine's fault tolerance on the CPU:
mirrors of the tests of ``tests/test_shard_fault.py`` that
``tests/test_torch_serving.py`` and ``tests/test_torch_fault_tolerance.py``
do not already mirror (save/load, corruption, sharded snapshot and restore,
structured fan-out failures, timeout and probe, injected transients, a
crashed and a recovered shard behind the serving runtime), files carried
across in both directions between the reference and the port, and the
sharded ``--serve`` CLI on the host.

One shard on ``"cpu"`` as in the reference file (the fan-out, health and
snapshot machinery is the same at any shard count), two where a test
carries a reference snapshot directory. A carried index searches with the
reference at ``TIGHT`` (rtol 1e-4, atol 1e-5: lam=1, where the two
packages' fp32 GEMMs differ by at most 3.7e-5 relative on
``small_corpus``, ROADMAP queue 3, P1) and a carried sharded snapshot at
``R2`` (rtol 1e-3, atol 5e-3, the reference's own batched-vs-looped
spread at lam=8), ids under the near-tie rule.
"""
import asyncio
import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.index import WmdEngine as RefEngine
from repro.core.index import build_index as ref_build_index
from repro.core.index import load_index as ref_load_index
from repro.core.index import save_index as ref_save_index
from repro_torch.core.index import (CorpusIndex, WmdEngine, build_index,
                                    index_from_arrays, load_index,
                                    save_index, snapshot_checksum)
from repro_torch.core.shard_index import (ShardSearchError, ShardedWmdEngine,
                                          append_docs_sharded, load_shards,
                                          shard_corpus)
from repro_torch.core.sparse import PaddedDocs
from repro_torch.runtime.serving import (FaultInjector, ServeConfig,
                                         ServingRuntime)

ROOT = Path(__file__).resolve().parents[1]
LAM = 1.0
N_ITER = 10
PRUNE = "rwmd"
TIGHT = dict(rtol=1e-4, atol=1e-5)
R2 = dict(rtol=1e-3, atol=5e-3)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread runs them faster, and far faster
    when several test workers share the host. Restored afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def sharded_engine(small_corpus):
    sindex = shard_corpus(small_corpus.docs, small_corpus.vecs, 1,
                          n_clusters=8, devices=["cpu"])
    return ShardedWmdEngine(sindex, lam=LAM, n_iter=N_ITER,
                            shard_retries=1, shard_backoff_s=0.001)


def _dist_equal(a, b) -> bool:
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


def _hold_ids(got, want, dists, tol):
    """Ids position by position, except inside runs of near-tied
    distances (neighbours within the tolerance, P1), which hold as sets."""
    got, want, d = (np.asarray(x) for x in (got, want, dists))
    start = 0
    for j in range(1, len(d) + 1):
        if j == len(d) or abs(d[j] - d[j - 1]) > 2 * (
                tol["atol"] + tol["rtol"] * abs(d[j])):
            assert set(got[start:j]) == set(want[start:j]), (got, want)
            start = j


def _arrays(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ------------------------------------------------------- index snapshots
def test_index_save_load_search_bitcompat(small_corpus, tmp_path):
    index = build_index(small_corpus.docs, small_corpus.vecs, n_clusters=8,
                        device="cpu")
    path = tmp_path / "index.npz"
    index.save(path)
    loaded = load_index(path, device="cpu")
    assert torch.equal(index.docs.idx, loaded.docs.idx)
    assert torch.equal(index.docs.val, loaded.docs.val)
    assert len(index.groups) == len(loaded.groups)
    assert CorpusIndex.load(path, device="cpu").n_docs == index.n_docs
    q = list(small_corpus.queries)
    a = WmdEngine(index, lam=LAM, n_iter=N_ITER).search(q, 5, prune=PRUNE)
    b = WmdEngine(loaded, lam=LAM, n_iter=N_ITER).search(q, 5, prune=PRUNE)
    assert np.array_equal(a.indices, b.indices)
    assert _dist_equal(a.distances, b.distances)


@pytest.mark.parametrize("fault", ["bitflip", "version"])
def test_index_snapshot_corruption_detected(small_corpus, tmp_path, fault):
    """A changed array under the old checksum, or a file of another
    format version (checksummed as it is), is refused by load_index and
    by index_from_arrays."""
    index = build_index(small_corpus.docs, small_corpus.vecs, n_clusters=8,
                        device="cpu")
    path = tmp_path / "index.npz"
    save_index(index, path)
    arrays = _arrays(path)
    if fault == "bitflip":
        arrays["val"] = arrays["val"] + 1e-3    # the checksum kept
        match = "integrity"
    else:
        arrays.pop("checksum")
        arrays["version"] = np.asarray(2, np.int64)
        arrays["checksum"] = np.asarray(snapshot_checksum(arrays), np.uint32)
        match = "version 2"
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(ValueError, match=match):
        load_index(path, device="cpu")
    with pytest.raises(ValueError, match=match):
        index_from_arrays(arrays, device="cpu")


def test_sharded_snapshot_restore_bitcompat(sharded_engine, small_corpus,
                                            tmp_path):
    engine = sharded_engine
    queries = list(small_corpus.queries)
    baseline = engine.search(queries, 5, prune=PRUNE)
    engine.snapshot(tmp_path)
    assert sorted(os.listdir(tmp_path)) == ["meta.npz", "shard_0000.npz"]
    engine.health.record_failure(0)            # pretend the shard died
    engine.restore_shard(0)
    assert not engine.health.is_open(0)
    assert engine.health.ema(0) is None        # clean record post-restore
    res = engine.search(queries, 5, prune=PRUNE)
    assert engine.last_coverage.full
    assert np.array_equal(baseline.indices, res.indices)
    assert _dist_equal(baseline.distances, res.distances)


def test_snapshot_requires_directory(sharded_engine):
    with pytest.raises(ValueError, match="snapshot directory"):
        sharded_engine.snapshot()
    with pytest.raises(ValueError, match="snapshot directory"):
        sharded_engine.restore_shard(0)


def test_stale_snapshot_rejected_after_append(small_corpus, tmp_path):
    sindex = shard_corpus(small_corpus.docs, small_corpus.vecs, 1,
                          n_clusters=8, devices=["cpu"])
    engine = ShardedWmdEngine(sindex, lam=LAM, n_iter=N_ITER,
                              snapshot_dir=tmp_path)
    engine.snapshot()
    grow = PaddedDocs(idx=small_corpus.docs.idx[:4],
                      val=small_corpus.docs.val[:4])
    engine.sindex = append_docs_sharded(engine.sindex, grow)
    with pytest.raises(ValueError, match="STALE"):
        engine.restore_shard(0)


# ------------------------------------------------------ fan-out failures
def test_raw_shard_exception_becomes_structured(sharded_engine,
                                                small_corpus):
    engine = sharded_engine

    def boom(*a, **kw):
        raise ValueError("boom")

    engine.engines[0].search = boom
    with pytest.raises(ShardSearchError, match="shard 0") as ei:
        engine.search(list(small_corpus.queries), 5, prune=PRUNE)
    assert ei.value.shard_reasons == {0: "ValueError: boom"}


@pytest.mark.parametrize("exc", [
    RuntimeError("transient device loss"),
    torch.cuda.OutOfMemoryError("CUDA out of memory"),
    OSError("transient I/O")])
def test_transient_shard_failure_retried_to_success(sharded_engine,
                                                    small_corpus, exc):
    """A RuntimeError (a CUDA error, a failed kernel launch), an
    out-of-memory error and an OSError are retried inside the shard's
    guard; the retried failure leaves no strike."""
    engine = sharded_engine
    orig = engine.engines[0].search
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise exc
        return orig(*a, **kw)

    engine.engines[0].search = flaky
    res = engine.search(list(small_corpus.queries), 5, prune=PRUNE)
    assert len(calls) == 2
    assert engine.last_coverage.full
    assert res.indices.shape == (3, 5)
    assert engine.health.failures[0] == 0


def test_timeout_opens_circuit_then_probe_readmits(small_corpus):
    """Two fan-outs past the deadline open the circuit; with every circuit
    open the next fan-out probes, and its success closes it. Only the
    hung fan-outs run under the 50 ms deadline, and their hang waits on an
    event (not a sleep that must outlast the deadline); the baseline and
    the probe run under 30 s, so no timing under load decides the
    outcome."""
    sindex = shard_corpus(small_corpus.docs, small_corpus.vecs, 1,
                          n_clusters=8, devices=["cpu"])
    engine = ShardedWmdEngine(sindex, lam=LAM, n_iter=N_ITER,
                              shard_timeout_s=30.0, shard_retries=0,
                              fail_threshold=2, probe_every=2)
    queries = list(small_corpus.queries)
    baseline = engine.search(queries, 5, prune=PRUNE)
    engine.shard_timeout_s = 0.05
    orig = engine.engines[0].search
    release = threading.Event()
    done = []

    def hang(*a, **kw):
        try:
            release.wait(60.0)
            return orig(*a, **kw)
        finally:
            done.append(1)

    engine.engines[0].search = hang
    for _ in range(2):
        with pytest.raises(ShardSearchError, match="timeout"):
            engine.search(queries, 5, prune=PRUNE)
    assert engine.health.is_open(0)
    assert engine.health.failures[0] == 2
    release.set()
    engine._pool.submit(lambda: None).result()  # one worker: drains both
    assert len(done) == 2
    engine.engines[0].search = orig
    engine.shard_timeout_s = 30.0
    res = engine.search(queries, 5, prune=PRUNE)
    assert not engine.health.is_open(0)
    assert engine.last_coverage.full
    assert np.array_equal(baseline.indices, res.indices)


def test_injected_shard_transient_retried(sharded_engine, small_corpus):
    """Site-5 injection at rate 1.0 fails every first attempt; the shard
    retry absorbs it and the request still succeeds at full coverage."""
    engine = sharded_engine
    injector = FaultInjector(shard_transient_rate=1.0,
                             shard_transient_attempts=1, seed=3)
    engine.shard_fault_hook = injector.before_shard_attempt
    res = engine.search(list(small_corpus.queries), 5, prune=PRUNE)
    assert engine.last_coverage.full
    assert res.indices.shape == (3, 5)
    assert any(t[0] == "shard_transient" for t in injector.trace)


# ----------------------------------------------- serving runtime surface
def _run_serving(engine, queries, injector=None, k=5):
    rt = ServingRuntime(
        engine,
        ServeConfig(max_batch=2, window_s=0.02, max_queue=64,
                    deadline_s=None, backoff_s=0.001, prune=PRUNE),
        injector=injector)

    async def go():
        await rt.start()
        futs = [rt.submit(q, k=k) for q in queries]
        out = await asyncio.gather(*futs)
        await rt.stop()
        return list(out)

    return asyncio.run(go()), rt


def test_crashed_only_shard_serves_structured_errors(sharded_engine,
                                                     small_corpus):
    """With the mesh's only shard crashed, every request still resolves,
    to a structured ``shard_failed`` error, not a hang."""
    engine = sharded_engine
    injector = FaultInjector(crash_shard=0, crash_after=0, seed=1)
    resps, rt = _run_serving(engine, list(small_corpus.queries),
                             injector=injector)
    assert len(resps) == 3
    assert all(not r.ok for r in resps)
    assert {r.error["code"] for r in resps} == {"shard_failed"}
    assert all("shard" in r.error["message"] for r in resps)
    stats = rt.stats()
    assert stats["shard_health"]["failures"][0] > 0


def test_recovered_shard_serves_clean_after_crash(sharded_engine,
                                                  small_corpus, tmp_path):
    engine = sharded_engine
    engine.snapshot(tmp_path)
    injector = FaultInjector(crash_shard=0, crash_after=0, seed=1)
    resps, _ = _run_serving(engine, list(small_corpus.queries),
                            injector=injector)
    assert all(not r.ok for r in resps)
    injector.revive_shard()
    engine.restore_shard(0)
    resps, rt = _run_serving(engine, list(small_corpus.queries),
                             injector=injector)
    assert all(r.ok and not r.partial for r in resps)
    assert rt.stats()["partial"] == 0


# ------------------------------------------------ files across packages
def test_reference_file_loads_in_port(small_corpus, tmp_path):
    """The reference's save_index file: the port's load_index reads it
    (checksum verified) and searches like the reference engine."""
    ref_index = ref_build_index(small_corpus.docs, small_corpus.vecs,
                                n_clusters=8)
    path = tmp_path / "ref.npz"
    ref_save_index(ref_index, path)
    port = load_index(path, device="cpu")
    assert np.array_equal(port.docs_host.idx, np.asarray(ref_index.docs.idx))
    assert np.array_equal(port.ext_ids, ref_index.ext_ids)
    q = list(small_corpus.queries)
    want = RefEngine(ref_index, lam=LAM, n_iter=N_ITER,
                     impl="sparse").search(q, 5, prune="ivf+wcd+rwmd")
    got = WmdEngine(port, lam=LAM, n_iter=N_ITER).search(
        q, 5, prune="ivf+wcd+rwmd")
    np.testing.assert_allclose(got.distances, want.distances, **TIGHT)
    for qi in range(len(q)):
        _hold_ids(got.indices[qi], want.indices[qi], want.distances[qi],
                  TIGHT)


def test_port_file_loads_in_reference(small_corpus, tmp_path):
    """A carried-over index saved by the port is the reference's file
    array for array, checksum included; an index the port built loads in
    the reference's load_index too."""
    ref_index = ref_build_index(small_corpus.docs, small_corpus.vecs,
                                n_clusters=8)
    ref_path, port_path = tmp_path / "ref.npz", tmp_path / "port.npz"
    ref_save_index(ref_index, ref_path)
    save_index(load_index(ref_path, device="cpu"), port_path)
    want, got = _arrays(ref_path), _arrays(port_path)
    assert sorted(want) == sorted(got)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key
    assert int(got["checksum"]) == int(want["checksum"])
    back = ref_load_index(port_path)
    assert np.array_equal(np.asarray(back.docs.idx),
                          np.asarray(ref_index.docs.idx))
    built = build_index(small_corpus.docs, small_corpus.vecs, n_clusters=8,
                        device="cpu")
    built_path = tmp_path / "built.npz"
    built.save(built_path)
    theirs = ref_load_index(built_path)
    assert np.array_equal(np.asarray(theirs.ext_ids), built.ext_ids)
    np.testing.assert_array_equal(np.asarray(theirs.vecs),
                                  built.vecs.numpy())


REF_SNAPSHOT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import numpy as np
    from repro.core import ShardedWmdEngine, shard_corpus
    from repro.data.corpus import make_corpus
    out = sys.argv[1]
    c = make_corpus(vocab_size=512, embed_dim=16, n_docs=96, n_queries=3,
                    seed=2)
    engine = ShardedWmdEngine(shard_corpus(c.docs, c.vecs, 2, n_clusters=12),
                              lam=8.0, n_iter=25, snapshot_dir=out)
    res = engine.search(list(c.queries), 5, prune="ivf+wcd+rwmd")
    engine.snapshot()
    np.savez(os.path.join(out, "result.npz"), indices=res.indices,
             distances=np.asarray(res.distances))
    print("REF_SNAPSHOT_OK")
""")


def test_reference_snapshot_dir_carried_into_port(tmp_path):
    """A directory the reference's snapshot_shards wrote over two devices
    (a subprocess: the reference's shard_corpus needs two XLA devices)
    loads shard by shard into the port, on two "cpu" positions, and the
    port's sharded search returns the reference's top-5."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", REF_SNAPSHOT,
                          str(tmp_path)], env=env, capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert "REF_SNAPSHOT_OK" in out.stdout, out.stdout + out.stderr
    want = _arrays(tmp_path / "result.npz")
    sindex = load_shards(tmp_path, devices=["cpu"])
    assert sindex.n_shards == 2 and sindex.n_docs == 96
    from repro_torch.data.corpus import make_corpus
    c = make_corpus(vocab_size=512, embed_dim=16, n_docs=96, n_queries=3,
                    seed=2)
    got = ShardedWmdEngine(sindex, lam=8.0, n_iter=25).search(
        list(c.queries), 5, prune="ivf+wcd+rwmd")
    np.testing.assert_allclose(got.distances, want["distances"], **R2)
    for qi in range(3):
        _hold_ids(got.indices[qi], want["indices"][qi],
                  want["distances"][qi], R2)


# ------------------------------------------------------------------ CLI
def test_serve_cli_shards_runs_on_cpu():
    """``--wmd --serve --shards 2 --device cpu --inject-shard-crash 1``:
    every request answered from shard 0 alone, tagged partial; the
    record names the shards and where they sit."""
    n = 6
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--wmd",
           "--serve", "--shards", "2", "--device", "cpu", "--n-docs", "48",
           "--vocab", "256", "--embed-dim", "8", "--requests", str(n),
           "--rate", "100", "--top-k", "4", "--prune", "ivf+wcd+rwmd",
           "--inject-shard-crash", "1"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=180, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    per_request, rec = lines[:-1], lines[-1]
    assert [r["rid"] for r in per_request] == list(range(n))
    assert all(r["ok"] and r["partial"] and not r["exact"]
               and r["missing_shards"] == [1] for r in per_request)
    assert rec["shards"] == 2 and sum(rec["docs_per_shard"]) == 48
    assert rec["placement"] == ["cpu", "cpu"]
    assert rec["stats"]["partial"] == n
    assert rec["stats"]["shard_health"]["failures"][1] > 0
