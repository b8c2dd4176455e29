"""What the host did in the measured window, for finding why host-paced
runs spread: the process's CPU time, Python's garbage collections, the
rate in equal slices of the window, and a fixed host workload timed just
after it. None of it is a metric; the result line carries it under
``host``. (Context switches and the machine's stolen time are left out:
the card's machine reports them as 0.)"""
from __future__ import annotations

import gc
import os
import resource
import time

import numpy as np

SLICES = 5


class GcClock:
    """Counts Python's garbage collections, and their seconds, while
    started."""

    def __init__(self):
        self.count, self.seconds, self._t = [0, 0, 0], 0.0, None

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.count[info["generation"]] += 1
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)


def snapshot() -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.perf_counter(), "cpu": ru.ru_utime + ru.ru_stime}


def probe_ms(reps: int = 5) -> float:
    """The median time of a fixed host workload (sorting 2**20 floats,
    the same on every run)."""
    x = np.random.default_rng(0).random(1 << 20, dtype=np.float32)
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        np.sort(x)
        out.append(time.perf_counter() - t)
    return float(np.median(out)) * 1e3


def report(before: dict, after: dict, gcc: GcClock, calls: list) -> dict:
    """The host's record of the window ``before`` .. ``after``."""
    wall = after["t"] - before["t"]
    slices = []
    if calls:
        t0, t1 = calls[0].t0, calls[-1].t1
        edges = np.linspace(t0, t1, SLICES + 1)
        ends = np.array([c.t1 for c in calls])
        done = np.array([len(c.positions) if c.answers is not None else 0
                         for c in calls])
        for lo, hi in zip(edges[:-1], edges[1:]):
            sel = (ends > lo) & (ends <= hi)
            slices.append(float(done[sel].sum() / (hi - lo)))
    return {"wall_s": wall,
            "cpu_s": after["cpu"] - before["cpu"],
            "gc_counts": list(gcc.count), "gc_s": gcc.seconds,
            "slices_qps": slices, "probe_ms": probe_ms(),
            "cpus": len(os.sched_getaffinity(0))}
