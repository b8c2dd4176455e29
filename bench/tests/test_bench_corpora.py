"""A configuration's corpus is drawn through one resolver
(``cell.make_corpus``): by ``bench/corpora/<corpus>.py`` where the
configuration names one, by ``bench/traffic/generate.py`` where it does
not, bit for bit as before the lookup existed."""
from __future__ import annotations

import hashlib
import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench_helpers import (ROOT, TINY_LIMITS, host_run, make_tree,
                           tiny_config)
from bench.traffic import generate
from bench.wmdbench import cell as cells

CONFIGS = ("paper_wmd", "news20_knn")
# sha256 of the tiny configurations make_tree wrote before corpus modules
# existed (their cut is the default's, unchanged)
TINY_SHA256 = {
    "paper_wmd":
        "c742fbabb626c8596bb53879963140527a0b08d87d8671510bc4dbd2fcf22645",
    "news20_knn":
        "0004de6aa40dbee2071afa010c9ba1f796f56733c3a8e0c7440672decbc5c253",
}

# a test-only corpus: the default's, with documents 0-7 copies of pool
# queries 0-7
COPIES = 8
CORPUS = "pool_copies"
CORPUS_SRC = '''
import numpy as np
from bench.traffic import generate

COPIES = %d


def make(config, seed, device):
    c = generate.make(config, seed, device)
    d, p = c.docs, c.pool
    sizes = np.concatenate([p.sizes()[:COPIES], d.sizes()[COPIES:]])
    docs = generate.Bags(
        ptr=np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64),
        ids=np.concatenate([p.ids[:p.ptr[COPIES]], d.ids[d.ptr[COPIES]:]]),
        w=np.concatenate([p.w[:p.ptr[COPIES]], d.w[d.ptr[COPIES]:]]))
    idx, val = generate.to_ell(docs)
    return generate.Corpus(vecs=c.vecs, docs=docs, idx=idx, val=val, pool=p)


def tiny(config):
    return dict(config, vocab_size=512, embed_dim=16, n_docs=96,
                query_pool=dict(config["query_pool"], size=256))
''' % COPIES
CELL = f"tiny_{CORPUS}.exhaustive_b64"
TWIN = "tiny_paper_wmd.exhaustive_b64"      # the same cell, default corpus

# records, in a host run, the window's first call's top-1 ids and whether
# the corpus the reference got holds the copies
RECORD = """
import json
import numpy as np
from bench.wmdbench import harness
_run_calls, _refs = harness.run_calls, harness.reference_distances
seen = {}
def run_calls(*a, **kw):
    calls = _run_calls(*a, **kw)
    seen["positions"] = list(calls[0].positions)
    seen["top1"] = [int(i) for i in calls[0].answers[0][:, 0]]
    return calls
def reference_distances(positions, corpus, *a, **kw):
    d, p = corpus.docs, corpus.pool
    seen["reference_saw_copies"] = all(
        np.array_equal(d.ids[d.ptr[i]:d.ptr[i + 1]],
                       p.ids[p.ptr[i]:p.ptr[i + 1]]) for i in range(%d))
    json.dump(seen, open("seen.json", "w"))
    return _refs(positions, corpus, *a, **kw)
harness.run_calls, harness.reference_distances = run_calls, reference_distances
""" % COPIES

# the control's readings, and the corpora it drew through the resolver
CONTROL = """
import json, sys
sys.path[:0] = [{tree!r}, {src!r}]
from bench.control import control_readings
from bench.wmdbench import cell
drawn, _make = [], cell.make_corpus
def make_corpus(config, *a, **kw):
    drawn.append(config.get("corpus"))
    return _make(config, *a, **kw)
cell.make_corpus = make_corpus
print(json.dumps([control_readings({name!r}, 7, "cpu"), drawn]))
"""


def add_cell(tree, config: dict, twin: str = TWIN) -> str:
    """Writes ``config`` and a cell ``<config>.<twin's mix>`` into the
    tree's files and ``BENCHMARK.json``, reported as ``twin`` is."""
    bench = tree / "bench"
    (bench / "configs" / f"{config['name']}.json").write_text(
        json.dumps(config))
    spec = json.loads((tree / "BENCHMARK.json").read_text())
    w = next(w for w in spec["workloads"] if w["name"] == twin)
    name = f"{config['name']}.{w['traffic'].removeprefix('tiny_')}"
    (bench / "workloads" / f"{name}.json").write_text(json.dumps(
        {"config": config["name"], "traffic": w["traffic"],
         "check": {"sample": 6, "limits": TINY_LIMITS["search"]}}))
    spec["workloads"].append(dict(w, name=name, config=config["name"]))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if twin in m.get("workloads", ()):
            m["workloads"].append(name)
    (tree / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return name


@pytest.mark.parametrize("name", CONFIGS)
def test_tiny_configs_are_unchanged(tree, name):
    raw = (tree / "bench" / "configs" / f"tiny_{name}.json").read_bytes()
    assert hashlib.sha256(raw).hexdigest() == TINY_SHA256[name], raw


@pytest.mark.parametrize("seed", [5, 2**31 + 7])
@pytest.mark.parametrize("name", CONFIGS)
def test_default_corpus_is_generate_make(name, seed):
    cfg = tiny_config(name)
    assert "corpus" not in cfg
    assert cells.corpus_module(cfg) is generate
    got = cells.make_corpus(cfg, seed, "cpu")
    want = generate.make(cfg, seed, "cpu")
    assert torch.equal(got.vecs, want.vecs)
    assert np.array_equal(got.idx, want.idx)
    assert np.array_equal(got.val, want.val)
    for part in ("docs", "pool"):
        for a, b in zip(getattr(got, part), getattr(want, part)):
            assert a.dtype == b.dtype and np.array_equal(a, b), part


def test_missing_corpus_fails_in_resolve(tmp_path):
    tree = make_tree(tmp_path)
    cfg = dict(tiny_config("paper_wmd"), name="no_corpus",
               corpus="no_such_corpus")
    name = add_cell(tree, cfg)
    path = tree / "bench" / "corpora" / "no_such_corpus.py"
    with pytest.raises(FileNotFoundError, match=re.escape(str(path))):
        cells.resolve(name, root=tree, bench=tree / "bench")


def test_named_corpus_is_drawn_end_to_end(tmp_path):
    tree = make_tree(tmp_path)
    bench = tree / "bench"
    (bench / "corpora").mkdir()
    (bench / "corpora" / f"{CORPUS}.py").write_text(CORPUS_SRC)
    full = json.loads((ROOT / "bench" / "configs" / "paper_wmd.json")
                      .read_text())
    (bench / "configs" / f"{CORPUS}.json").write_text(
        json.dumps(dict(full, name=CORPUS, corpus=CORPUS)))
    cfg = tiny_config(CORPUS, bench=bench)      # the module's own cut
    assert (cfg["name"], cfg["n_docs"], cfg["corpus"]) == (
        f"tiny_{CORPUS}", 96, CORPUS)
    assert add_cell(tree, cfg) == CELL
    cell = cells.resolve(CELL, root=tree, bench=bench)
    assert cell.config["corpus"] == CORPUS

    r = host_run(tree, CELL, seed=11, seconds=0.3, prelude=RECORD)
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    seen = json.loads((tree / "seen.json").read_text())
    assert seen["positions"][:COPIES] == list(range(COPIES))
    assert seen["top1"][:COPIES] == list(range(COPIES))
    assert seen["reference_saw_copies"] is True

    code = CONTROL.format(tree=str(tree), src=str(ROOT / "src"), name=CELL)
    out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got, drawn = json.loads(out.stdout.strip().splitlines()[-1])
    assert drawn == [CORPUS]
    assert set(got) == set(TINY_LIMITS["search"])
    assert all(np.isfinite(v) for v in got.values())
