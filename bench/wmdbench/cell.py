"""Finding a cell and what belongs to it, by name, in data files.

``BENCHMARK.json`` (at the checkout's root) lists the cells and the
metrics. A cell ``<cell>`` is ``bench/workloads/<cell>.json``, which names
its configuration (``bench/configs/<config>.json``), its traffic mix
(``bench/traffic/<mix>.json``, whose ``entry`` names the module
``bench/entries/<entry>.py`` that drives the program) and the limits of its
correctness check. A metric ``<name>`` is read by
``bench/metrics/<name>.py``. Adding a cell, a configuration, a mix or a
metric is adding files and entries of ``BENCHMARK.json``; nothing here
names one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


class Cell(NamedTuple):
    name: str
    spec: dict          # the cell's own file
    config: dict
    traffic: dict
    chips: int
    end_to_end: list    # BENCHMARK.json metric entries this cell reports
    per_layer: list


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _load(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str, e2e_names=None) -> bool:
    """A metric with ``workloads`` is reported in those cells; without,
    an end-to-end metric in every cell and a per-layer one wherever the
    end-to-end metric it moves is (``e2e_names``)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def resolve(name: str, root: Path = ROOT, bench: Path = BENCH) -> Cell:
    """The cell ``name`` with its configuration, mix and metrics. Raises
    ``KeyError`` for a cell ``BENCHMARK.json`` does not list and
    ``ValueError`` where the cell file disagrees with it."""
    spec_all = benchmark(root)
    entry = next((w for w in spec_all["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    spec = _load(bench / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if spec[key] != entry[key]:
            raise ValueError(f"{name}: {key} is {spec[key]!r} in its file "
                             f"and {entry[key]!r} in BENCHMARK.json")
    config = _load(bench / "configs" / f"{spec['config']}.json")
    traffic = _load(bench / "traffic" / f"{spec['traffic']}.json")
    e2e = [m for m in spec_all["end_to_end"] if _applies(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec_all["per_layer"]
                 if _applies(m, name, names)]
    return Cell(name=name, spec=spec, config=config, traffic=traffic,
                chips=int(entry["chips"]), end_to_end=e2e,
                per_layer=per_layer)


def entry_module(traffic: dict):
    """The module that drives the traffic's entry point
    (``bench/entries/``)."""
    return importlib.import_module(f"bench.entries.{traffic['entry']}")


def metric_reader(name: str, bench: Path = BENCH):
    """The module that reads metric ``name`` (``bench/metrics/<name>.py``;
    names may hold dots, so it is loaded from its path)."""
    path = bench / "metrics" / f"{name}.py"
    mod_name = "bench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
