"""The last line's schema, untraced and traced, and the checks printed
last on standard error and last in the line."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from bench_helpers import HOST_RUN, ROOT, host_run

SHORT_TRACE = "import bench.wmdbench.harness as h; h.TRACE_SECONDS = 0.2"


def _check_schema(r: dict, trace: bool):
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in r
    assert list(r)[-1] == "checks"
    assert isinstance(r["correct"], bool)
    assert r["attempted"] > 0 and r["failed"] == 0
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], float)
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        assert key in r["device"]
    if trace:
        assert "busy_s" in r["device"] and "window_s" in r["device"]
        b = r["breakdown"]
        assert set(b) == {"device_ops", "idle_gaps"}
        assert all(len(x) <= 10 for x in b.values())
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("cell, rate", [
    ("tiny_paper_wmd.exhaustive_b64", "queries_per_s"),
    ("tiny_paper_wmd.one_query", "queries_per_s"),
    ("tiny_news20_knn.exhaustive_b64", "queries_per_s.card_paced")])
def test_untraced_line(tree, cell, rate):
    r = host_run(tree, cell, seconds=0.3)
    _check_schema(r, trace=False)
    assert set(r["metrics"]) == {rate, "setup_s"}


def test_traced_line(tree):
    r = host_run(tree, "tiny_news20_knn.rwmd_b64", seconds=0.3, trace=True,
                 prelude=SHORT_TRACE)
    _check_schema(r, trace=True)
    # the host has no device events: device metrics are left out, not 0
    assert "device_idle_pct" not in r["metrics"]
    assert "solved_share_pct" in r["metrics"]


def test_checks_are_the_last_lines_of_stderr(tree):
    code = HOST_RUN.format(tree=str(tree), src=str(ROOT / "src"),
                           prelude="", cell="tiny_paper_wmd.one_query",
                           seed=11, seconds=0.2, trace=False)
    out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                         capture_output=True, text=True, timeout=300)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    tail = out.stderr.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    assert all(t.startswith("check ") and " limit " in t for t in tail)
