"""Every cell resolves by name to its files, a cell added as files is found
with no code edited, and BENCHMARK.json keeps its required forms."""
from __future__ import annotations

import json
import re

import pytest

from bench_helpers import ROOT, host_run
from bench.wmdbench import cell as cells

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_to_its_files(w):
    c = cells.resolve(w["name"])
    assert c.config["name"] == w["config"]
    assert c.chips == 1
    mod = cells.entry_module(c.traffic)
    assert hasattr(mod, "System") and hasattr(mod, "compare")
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(cells.metric_reader(m["name"]).read)
    assert set(c.spec["check"]["limits"]) == set(
        mod.compare(*_perfect_answer(mod, c)).keys())


def _perfect_answer(mod, c):
    import numpy as np
    ref = np.linspace(1.0, 2.0, 20)
    if c.traffic["entry"] == "search":
        k = c.traffic["k"]
        return (np.arange(k), ref[:k], 20), ref, k
    return ref.copy(), ref, 0


def test_benchmark_json_forms():
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    assert set(SPEC) == keys
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for cfg in SPEC["configs"]:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / cfg["file"]).exists()
        assert 1 <= len(cfg["source"]) <= 200
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"] != "setup_s":
            assert m["source"] in ("host_clock", "device_trace",
                                   "program_counter", "program_span")
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert "\n" not in m["layer"]
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_added_cell_is_found_without_code_edits(tree):
    """make_tree added configs, mixes, cells and BENCHMARK.json entries
    only; the harness finds and runs the new cell."""
    c = cells.resolve("tiny_paper_wmd.exhaustive_b64", root=tree,
                      bench=tree / "bench")
    assert c.config["vocab_size"] == 512 and c.traffic["batch"] == 8
    r = host_run(tree, "tiny_paper_wmd.exhaustive_b64", seconds=0.3)
    assert r["correct"] is True and r["failed"] == 0


def test_cell_file_must_agree_with_benchmark(tmp_path):
    from bench_helpers import make_tree
    t = make_tree(tmp_path)
    f = t / "bench" / "workloads" / "tiny_paper_wmd.one_query.json"
    spec = json.loads(f.read_text())
    spec["traffic"] = "exhaustive_b64"
    f.write_text(json.dumps(spec))
    with pytest.raises(ValueError):
        cells.resolve("tiny_paper_wmd.one_query", root=t, bench=t / "bench")
    with pytest.raises(KeyError):
        cells.resolve("no_such.cell", root=t, bench=t / "bench")
