"""The correctness check: a sample of the window's answers, drawn from the
seed once the window has closed, against the plain reference.

Each compared number is the widest over the sample; a run is correct when
no query failed and every number is at most its limit (the cell file's
``check.limits``). The limits, and the readings they were set from, are
in PERF.md."""
from __future__ import annotations

import math

import numpy as np

from bench.reference.wmd import wmd_one_to_all
from bench.traffic.generate import STREAM_SAMPLE, rng


def sample(calls: list, system, seed: int, size: int) -> list:
    """(pool position, answer) of ``size`` answered queries drawn from the
    seed once the window has closed, in the order they were answered."""
    answered = [(p, a) for c in calls if c.answers is not None
                for p, a in zip(c.positions, system.answers(c.answers))]
    if len(answered) <= size:
        return answered
    pick = np.sort(rng(seed, STREAM_SAMPLE).choice(len(answered), size,
                                                   replace=False))
    return [answered[i] for i in pick]


def reference_distances(positions, corpus, config: dict, traffic: dict,
                        tf32: bool = False) -> list:
    """The reference's (N,) distances of each pool query at
    ``positions``; ``tf32`` computes them as the control does."""
    lam = float(traffic.get("lam", config["lam"]))
    n_iter = int(traffic.get("n_iter", config["n_iter"]))
    pool = corpus.pool
    return [wmd_one_to_all(pool.ids[pool.ptr[p]:pool.ptr[p + 1]],
                           pool.w[pool.ptr[p]:pool.ptr[p + 1]], corpus.vecs,
                           corpus.idx, corpus.val, lam, n_iter, tf32=tf32)
            for p in positions]


def readings(answers: list, refs: list, compare, k: int) -> dict:
    """The widest of each compared number over the answers (a non-finite
    reading counts as inf)."""
    worst: dict = {}
    for answer, ref in zip(answers, refs):
        for name, value in compare(answer, ref, k).items():
            value = value if math.isfinite(value) else math.inf
            worst[name] = max(worst.get(name, 0.0), value)
    return worst


def verdict(readings: dict, limits: dict, failed: int) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}); a number without a limit,
    or a limit without a number, is not correct."""
    checks = {"failed": {"value": failed, "limit": 0}}
    ok = failed == 0
    for name in sorted(set(readings) | set(limits)):
        value = readings.get(name)
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and limit is not None \
            and value <= limit
    return ok, checks
