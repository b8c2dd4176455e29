"""Helpers of the benchmark's CPU tests: a copy of the benchmark's files
with tiny cells added, and a run of the harness on the host in it."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# tiny sizes: widths and counts cut so the host runs a cell in seconds
TINY = {"vocab_size": 512, "embed_dim": 16, "n_docs": 96}
TINY_POOL = 256
# the host runs the kernels' plain versions at w = 16, whose fp32 distance
# of a word to itself (~1e-3, not 0) reads ~4e-4 against the float64
# reference
TINY_LIMITS = {"search": {"topk_gap": 2e-3}, "one_to_many": {"dist_gap": 1e-3}}


def tiny_config(name: str, bench: Path = ROOT / "bench") -> dict:
    """The configuration ``name`` cut by its corpus module's ``tiny``, or,
    for the default corpus, by :func:`tiny_default`; named
    ``tiny_<name>``."""
    from bench.wmdbench import cell as cells
    cfg = json.loads((bench / "configs" / f"{name}.json").read_text())
    cut = (cells.corpus_module(cfg, bench).tiny if "corpus" in cfg
           else tiny_default)(cfg)
    cut["name"] = f"tiny_{name}"
    return cut


def tiny_default(cfg: dict) -> dict:
    """The cut of a configuration drawn by ``bench/traffic/generate.py``."""
    cfg = dict(cfg, **TINY)
    cfg["query_pool"] = dict(cfg["query_pool"], size=TINY_POOL)
    for key in ("doc_words",):
        spec = dict(cfg[key])
        if spec["kind"] == "lognormal":
            spec.update(median=20, max_unique=40)
        cfg[key] = spec
        cfg["query_pool"]["words"] = spec
    return cfg


def make_tree(dest: Path, traffic_batch: int | None = 8) -> Path:
    """``dest`` with ``BENCHMARK.json`` and ``bench/``, plus a tiny cell
    ``tiny_<config>.<mix>`` for every cell of the benchmark (files and
    entries only). Returns ``dest``."""
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cfg in spec["configs"]:
        tiny = tiny_config(cfg["name"])
        (dest / "bench" / "configs" / f"{tiny['name']}.json").write_text(
            json.dumps(tiny))
    for w in list(spec["workloads"]):
        mix = json.loads((ROOT / "bench" / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        if traffic_batch and mix["batch"] > 1:
            mix["batch"] = traffic_batch
        mix_name = f"tiny_{w['traffic']}"
        (dest / "bench" / "traffic" / f"{mix_name}.json").write_text(
            json.dumps(mix))
        name = f"tiny_{w['config']}.{w['traffic']}"
        (dest / "bench" / "workloads" / f"{name}.json").write_text(
            json.dumps({"config": f"tiny_{w['config']}", "traffic": mix_name,
                        "check": {"sample": 6,
                                  "limits": TINY_LIMITS[mix["entry"]]}}))
        spec["workloads"].append(dict(w, name=name,
                                      config=f"tiny_{w['config']}",
                                      traffic=mix_name))
        for m in spec["per_layer"] + spec["end_to_end"]:
            if w["name"] in m.get("workloads", ()):
                m["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest


HOST_RUN = """
import json, sys, time
sys.path[:0] = [{tree!r}, {src!r}]
from bench.wmdbench.harness import dumps, run
{prelude}
print(dumps(run({cell!r}, {seed}, {seconds}, {trace}, time.perf_counter(),
                device="cpu")))
"""


def host_run(tree: Path, cell: str, seed: int = 7, seconds: float = 0.5,
             trace: bool = False, prelude: str = "") -> dict:
    """The result line of one run of ``cell`` on the host (the harness's
    look for a card skipped), in a fresh process."""
    code = HOST_RUN.format(tree=str(tree), src=str(ROOT / "src"),
                           prelude=prelude, cell=cell, seed=seed,
                           seconds=seconds, trace=trace)
    out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])
