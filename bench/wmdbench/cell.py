"""Finding a cell and what belongs to it, by name, in data files.

``BENCHMARK.json`` (at the checkout's root) lists the cells and the
metrics. A cell ``<cell>`` is ``bench/workloads/<cell>.json``, which names
its configuration (``bench/configs/<config>.json``), its traffic mix
(``bench/traffic/<mix>.json``, whose ``entry`` names the module
``bench/entries/<entry>.py`` that drives the program) and the limits of its
correctness check. A configuration that holds ``"corpus": "<corpus>"`` is
drawn by ``bench/corpora/<corpus>.py``; one without the key by
``bench/traffic/generate.py``, the default. A metric ``<name>`` is read by
``bench/metrics/<name>.py``. Adding a cell, a configuration, a corpus, a
mix or a metric is adding files and entries of ``BENCHMARK.json``; nothing
here names one.

A corpus module provides ``make(config, seed, device) -> Corpus`` (the
``Corpus`` of ``generate.py``, whose helpers it may use; it imports nothing
of the program) and ``tiny(config) -> dict``, the configuration cut to a
size the host runs in seconds (the CPU tests' cut).
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
    ``KeyError`` for a cell ``BENCHMARK.json`` does not list,
    ``ValueError`` where the cell file disagrees with it and
    ``FileNotFoundError`` where its configuration names a corpus that has
    no module."""
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
    _corpus_file(config, bench)
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


def _corpus_file(config: dict, bench: Path = BENCH) -> Path | None:
    """``bench/corpora/<corpus>.py`` of a configuration that names its
    corpus, None for the default; raises ``FileNotFoundError`` where the
    file is missing."""
    name = config.get("corpus")
    if name is None:
        return None
    path = bench / "corpora" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no corpus {name!r} at {path}")
    return path


def corpus_module(config: dict, bench: Path = BENCH):
    """The module that draws the configuration's corpus (the module
    docstring)."""
    path = _corpus_file(config, bench)
    if path is None:
        return importlib.import_module("bench.traffic.generate")
    return _module_at(path, "bench_corpus_" + _ident(config["corpus"]))


def make_corpus(config: dict, seed: int, device, bench: Path = BENCH):
    """The configuration's corpus and query pool for ``seed``: what every
    caller draws its data through."""
    return corpus_module(config, bench).make(config, seed, device)


def metric_reader(name: str, bench: Path = BENCH):
    """The module that reads metric ``name`` (``bench/metrics/<name>.py``;
    names may hold dots, so it is loaded from its path)."""
    path = bench / "metrics" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    return _module_at(path, "bench_metric_" + _ident(name))


def _ident(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def _module_at(path: Path, mod_name: str):
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
