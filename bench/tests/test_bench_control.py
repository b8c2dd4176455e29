"""The control: the plain reference with its distance product in TF32 (the
precision below the configuration's fp32 with TF32 off), put in the
program's place, fails the cell's own limits. At the published width
w = 300 (what sets the rounding of the distances), with fewer words and
documents so that the host holds it."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from bench_helpers import ROOT
from bench.reference import wmd as reference
from bench.traffic import generate
from bench.wmdbench import cell as cells
from bench.wmdbench.check import readings, reference_distances

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, 3.0e-3])
    y = reference.round_tf32(x)
    assert y[0] == 1.0 and y[1] in (1.0, 1.0 + 2**-10)
    assert y[2] == 1.0 + 2**-10
    assert abs(float(y[3]) - 3e-3) / 3e-3 < 2**-10


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_cell_limits(name):
    cell = cells.resolve(name)
    entry = cells.entry_module(cell.traffic)
    cfg = dict(cell.config, vocab_size=2048, n_docs=160,
               query_pool=dict(cell.config["query_pool"], size=8))
    corpus = generate.make(cfg, 21, "cpu")
    k = int(cell.traffic.get("k", 0))
    ctl = reference_distances(range(4), corpus, cfg, cell.traffic, tf32=True)
    ref = reference_distances(range(4), corpus, cfg, cell.traffic)
    worst = readings([entry.from_distances(d, k) for d in ctl], ref,
                     entry.compare, k)
    limits = cell.spec["check"]["limits"]
    assert any(worst[n] > limits[n] for n in limits), (worst, limits)
    assert np.isfinite(list(worst.values())).all()
    # the reference itself in the program's place reads far under them
    same = readings([entry.from_distances(d, k) for d in ref], ref,
                    entry.compare, k)
    assert all(same[n] < 0.01 * limits[n] for n in limits)
