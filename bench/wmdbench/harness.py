"""One run of one cell: set-up, the measured window, the traced window
(``trace``), the metrics, the correctness check and the result line."""
from __future__ import annotations

import gc
import json
import sys
import time
from typing import NamedTuple

import numpy as np

from bench.wmdbench import cell as cells, hoststate
from bench.wmdbench.check import (readings, reference_distances, sample,
                                   verdict)
from bench.wmdbench.window import run_calls

# top-level module names that may not be loaded once the window has closed
# (JAX, and the JAX package of this repository; repro_torch is the port)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# seconds of calls under the profiler in a traced run
TRACE_SECONDS = 2.0


class RunView(NamedTuple):
    """What a metric reader reads."""
    cell: cells.Cell
    corpus: object
    system: object
    calls: list         # the measured window's calls
    trace: object       # profile.Trace of the traced window, or None
    setup_s: float


class Failure(RuntimeError):
    """The run cannot give a result (no card, a forbidden module)."""


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _device_info(device, chips: int) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(name: str, seed: int, seconds: float, trace: bool, t_start: float,
        device=None, log=sys.stderr) -> dict:
    """The result of one run (the dict printed as the last line).
    ``device=None`` is the card, which must be there; tests pass
    ``"cpu"``."""
    import torch
    cell = cells.resolve(name)
    if device is None:
        if not torch.cuda.is_available():
            raise Failure("no CUDA device: the benchmark measures the card")
        if torch.cuda.device_count() < cell.chips:
            raise Failure(f"{name} needs {cell.chips} cards, "
                          f"{torch.cuda.device_count()} present")
        device = "cuda:0"
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = bool(cell.config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cell.config["tf32"])

    parts = {"imports_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    corpus = cells.make_corpus(cell.config, seed, device)
    _sync(device)
    parts["data_s"] = time.perf_counter() - t
    t = time.perf_counter()
    entry = cells.entry_module(cell.traffic)
    system = entry.System(corpus, cell.config, cell.traffic, device)
    _sync(device)
    parts["system_s"] = time.perf_counter() - t
    batch = int(cell.traffic["batch"])
    pool_n = corpus.pool.n
    t = time.perf_counter()
    for i, positions in enumerate(system.warm_batches(batch)):
        system.call(system.rows(positions))
        if i == 0:
            _sync(device)
            parts["first_call_s"] = time.perf_counter() - t
    _sync(device)
    parts["warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    before = hoststate.snapshot()
    with hoststate.GcClock() as gcc:
        calls = run_calls(system, batch, pool_n, seconds)
    host = hoststate.report(before, hoststate.snapshot(), gcc, calls)
    tr = None
    if trace:
        from bench.wmdbench.profile import traced_calls
        readers = {m["name"]: cells.metric_reader(m["name"])
                   for m in cell.per_layer}
        for mod in readers.values():
            if hasattr(mod, "instrument"):
                mod.instrument(system)
        _reset_launch_counts()
        tr = traced_calls(system, batch, pool_n, TRACE_SECONDS,
                          start=len(calls) * batch, device=device)
    _sync(device)
    dev_info = _device_info(device, cell.chips)
    bad = forbidden_modules()
    if bad:
        raise Failure(f"loaded once the window closed: {bad}")

    view = RunView(cell=cell, corpus=corpus, system=system, calls=calls,
                   trace=tr, setup_s=setup_s)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        mod = readers[m["name"]] if trace else cells.metric_reader(m["name"])
        value = mod.read(view)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    all_calls = calls + (tr.calls if tr is not None else [])
    attempted = sum(len(c.positions) for c in all_calls)
    failed = sum(len(c.positions) if c.answers is None
                 else sum(system.failed(a) for a in system.answers(c.answers))
                 for c in all_calls)
    picked = sample(all_calls, system, seed,
                    int(cell.spec["check"]["sample"]))
    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace:
        from bench.wmdbench.profile import breakdown
        result["device"]["busy_s"] = tr.busy_us() / 1e6
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = breakdown(tr)
        result["kernel_launches"] = _launch_counts()
    result["setup_parts"] = parts
    result["host"] = host
    dur = np.array([c.t1 - c.t0 for c in calls]) * 1e3
    if dur.size:
        result["calls"] = {"n": int(dur.size),
                           "median_ms": float(np.median(dur)),
                           "p95_ms": float(np.percentile(dur, 95)),
                           "max_ms": float(dur.max())}
    errors = sorted({c.error for c in all_calls if c.error})[:3]
    if errors:
        result["errors"] = errors

    # the reference runs on the card once the program's state is freed
    system.free()
    del system, view
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    refs = reference_distances([p for p, _ in picked], corpus, cell.config,
                               cell.traffic)
    got = readings([a for _, a in picked], refs, entry.compare,
                   int(cell.traffic.get("k", 0)))
    correct, checks = verdict(got, cell.spec["check"]["limits"], failed)
    result["correct"] = bool(correct and len(picked) > 0)
    result["check_seconds"] = time.perf_counter() - t_ref
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=log)
    return result


def _reset_launch_counts() -> None:
    from repro_torch.kernels import ops
    ops.reset_launches()


def _launch_counts() -> dict:
    """The program's own count of its hand-written kernels' launches
    (``repro_torch.kernels.ops.launches``) in the traced window."""
    from repro_torch.kernels import ops
    return {k: v for k, v in ops.launches().items() if v}


def _finite(x):
    if isinstance(x, float) and not np.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def dumps(result: dict) -> str:
    """The result line, strict JSON (a non-finite number as a string),
    ``checks`` last."""
    checks = result.pop("checks", None)
    if checks is not None:
        result["checks"] = checks
    return json.dumps(_finite(result))
