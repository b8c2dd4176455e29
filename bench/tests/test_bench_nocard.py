"""A measurement with no card fails and prints no result: it never falls
back to the host. The card is hidden from the process, so the test holds
on a machine with one as well."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_helpers import HOST_RUN, ROOT


def _run(cwd, workload="paper_wmd.one_query"):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", workload, "--seed",
         "5", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def _no_result(out):
    for line in out.stdout.strip().splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    _no_result(out)


def test_benchmark_files_alone_are_not_a_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and bench/, a run
    (here on the host, past the look for a card) cannot find the program:
    it fails and prints no result."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = HOST_RUN.format(tree=str(tmp_path), src=str(tmp_path / "src"),
                           prelude="", cell="paper_wmd.one_query", seed=1,
                           seconds=0.1, trace=False)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert "repro_torch" in out.stderr
    _no_result(out)


@pytest.mark.gpu
def test_card_run_of_a_tiny_cell(tree):
    """On the card: a tiny cell through bench/run.py (skips without one)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "tiny_paper_wmd.exhaustive_b64", "--seed", "9", "--seconds", "1",
         "--trace", "1"], cwd=tree, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0
