"""The port's two examples run end to end on the host, at a small size,
in a subprocess (as a user runs them from the repo root)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(*argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, *argv], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_quickstart_on_cpu():
    out = _run("examples/torch_quickstart.py", "--device", "cpu")
    rows = [ln for ln in out.splitlines() if "nearest docs" in ln]
    assert [r.split()[0] for r in rows] == ["dense", "sparse", "kernel"]
    # every solver finds the same nearest documents
    assert len({r.split("nearest docs:")[1].split("distances")[0]
                for r in rows}) == 1
    assert "WMD range" in out


@pytest.mark.parametrize("extra", [
    [], ["--prune", "ivf+wcd+rwmd", "--shards", "2"],
    ["--looped", "--impl", "sparse"]])
def test_wmd_search_on_cpu(extra):
    out = _run("examples/torch_wmd_search.py", "--device", "cpu",
               "--n-docs", "96", "--vocab", "1024", "--queries", "3",
               "--batches", "1", *extra)
    assert out.count("top-5 = ") == 3
    assert "batch latency" in out
    if "--shards" in extra:
        assert "sharded: 2 cluster-aligned shards" in out


def test_train_moe_sinkhorn_on_cpu():
    out = _run("examples/torch_train_moe_sinkhorn.py", "--device", "cpu",
               "--steps", "3", "--batch", "2", "--seq-len", "32")
    assert "router=sinkhorn" in out.splitlines()[0]
    steps = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert [int(ln.split()[1]) for ln in steps] == [0, 2]
    assert "trained 3 steps in" in out
    drops = {ln.split()[0]: float(ln.split()[-1]) for ln in out.splitlines()
             if "token-drop fraction at capacity" in ln}
    assert set(drops) == {"router=topk", "router=sinkhorn"}
    assert all(0.0 <= d <= 1.0 for d in drops.values())
