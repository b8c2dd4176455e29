"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole: ``repro_torch`` is the port), and the reference imports
nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys

from bench_helpers import HOST_RUN, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_no_forbidden_module_after_a_run(tree):
    code = HOST_RUN.format(
        tree=str(tree), src=str(ROOT / "src"), prelude="",
        cell="tiny_news20_knn.rwmd_b64", seed=3, seconds=0.2, trace=False)
    code += ("\nimport bench.wmdbench.profile, bench.wmdbench.roofline\n"
             "from bench.wmdbench import cell\n"
             "import json, pathlib\n"
             "for m in json.load(open('BENCHMARK.json'))['per_layer']:\n"
             "    cell.metric_reader(m['name'])\n"
             "top = {m.split('.')[0] for m in sys.modules}\n"
             "print(sorted(top & %r))\n"
             "print('repro_torch' in top)\n" % FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-2:] == ["[]", "True"]


def test_forbidden_check_compares_whole_names():
    from bench.wmdbench import harness
    assert "repro" in harness.FORBIDDEN
    saved = dict(sys.modules)
    try:
        sys.modules.pop("repro", None)
        sys.modules["repro_torch_lookalike"] = sys
        assert "repro" not in harness.forbidden_modules()
        sys.modules["repro.core"] = sys
        assert harness.forbidden_modules() == ["repro"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax_and_reference_nothing_of_the_program():
    for path in (ROOT / "bench").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, path
        assert "benchmarks" not in tops, path
    for path in (ROOT / "bench" / "reference").rglob("*.py"):
        assert all(not m.startswith("repro_torch")
                   for m in _imports(path)), path
