"""The port stands alone: it imports no JAX and nothing of the reference
package, its entry points refuse to fall back to the CPU, and its serve
CLI runs on the host when asked. No port test imports the reference's
dry-run, which changes process-wide state when imported."""
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\.|"
                       r"from repro\.|from repro import|import repro\s*$)",
                       re.MULTILINE)


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_imports_no_jax_and_no_reference_package():
    mods = list(_port_modules())
    for m in ("repro_torch.kernels.ops", "repro_torch.core.wmd",
              "repro_torch.core.exact_ot", "repro_torch.core.sinkhorn",
              "repro_torch.core.sinkhorn_sparse", "repro_torch.core.kcache",
              "repro_torch.core.sparse", "repro_torch.core.router",
              "repro_torch.configs.base", "repro_torch.models.layers",
              "repro_torch.models.moe", "repro_torch.models.transformer",
              "repro_torch.models.model", "repro_torch.models.convert",
              "repro_torch.models.rwkv6", "repro_torch.models.mamba2",
              "repro_torch.optim.adamw", "repro_torch.optim.schedules",
              "repro_torch.checkpoint.checkpointer",
              "repro_torch.launch.train", "repro_torch.runtime.compression",
              "repro_torch.data.pipeline", "repro_torch.launch.dryrun",
              "repro_torch.launch.mesh", "repro_torch.runtime.analysis"):
        assert m in mods
    assert len(mods) >= 45
    from repro_torch.kernels import ops
    for fn in ("bsr_sddmm", "bsr_sddmm_blocks"):
        assert callable(getattr(ops, fn))
    assert "bsr_sddmm_blocks" in ops.launches()
    script = "\n".join(
        ["import importlib, sys",
         f"sys.path.insert(0, {str(ROOT)!r})",
         *[f"importlib.import_module({m!r})" for m in mods],
         "import chip_smoke",          # runs only its import block
         "bad = sorted(m for m in sys.modules if m == 'jax' or "
         "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))",
         "assert not bad, bad",
         "print('ok', len(sys.modules))"])
    out = subprocess.run([sys.executable, "-c", script], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_core_reexports_every_reference_name():
    """Every public name of ``repro.core`` resolves on ``repro_torch.core``
    (``count_collectives`` with the port's run-time signature)."""
    import repro.core
    import repro_torch.core
    names = list(repro.core.__all__)
    assert len(names) == 56
    missing = [n for n in names if not hasattr(repro_torch.core, n)]
    assert not missing, missing
    assert sorted(repro_torch.core.__all__) == sorted(names)
    from repro_torch.core import WmdEngine, build_index, route  # noqa: F401


def test_no_source_line_imports_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] \
        + sorted((ROOT / "examples").glob("torch_*.py"))
    for path in files:
        hit = FORBIDDEN.search(path.read_text())
        assert hit is None, f"{path}: {hit.group(0).strip()}"


def test_entry_points_refuse_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.core.index import build_index, index_from_arrays
    from repro_torch.data.corpus import make_corpus
    c = make_corpus(vocab_size=32, embed_dim=4, n_docs=6, n_queries=1,
                    words_per_doc=(2, 4), seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_index(c.docs, c.vecs)
    with pytest.raises(RuntimeError, match="CUDA"):
        index_from_arrays({"idx": c.docs.idx}, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_index(c.docs, c.vecs, device="cuda")
    index = build_index(c.docs, c.vecs, device="cpu")
    assert index.device == torch.device("cpu")
    from repro_torch.core import one_to_many
    with pytest.raises(RuntimeError, match="CUDA"):
        one_to_many(c.queries[0], c.docs, c.vecs, 1.0, 3, impl="kernel")
    out = one_to_many(c.queries[0], c.docs, c.vecs, 1.0, 3, impl="kernel",
                      device="cpu")
    assert out.device == torch.device("cpu")


def test_serve_cli_runs_on_cpu():
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--wmd",
           "--device", "cpu", "--n-docs", "48", "--vocab", "256",
           "--embed-dim", "8", "--steps", "2", "--batch-queries", "3",
           "--top-k", "4", "--prune", "rwmd", "--lam", "1.0"]
    out = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                         timeout=180, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["workload"] == "wmd_topk" and rec["device"] == "cpu"
    assert rec["top_k"] == 4 and 0 < rec["solved_frac"] <= 1
    assert np.isfinite(rec["ms_per_batch_p50"])


DRYRUN = "repro.launch.dryrun"


def dryrun_imports(source: str) -> list:
    """Lines of ``source`` that import the reference's dry-run: an
    ``import`` or ``from ... import`` statement, or an ``import_module`` /
    ``__import__`` call naming it; text inside string literals (a script
    run in a subprocess) is not code and is not matched."""
    hits = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mod = node.module or ""
            names = [mod] + [f"{mod}.{a.name}" for a in node.names]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names = [str(node.args[0].value)]
        else:
            continue
        if any(n == DRYRUN or n.startswith(DRYRUN + ".") for n in names):
            hits.append(node.lineno)
    return hits


def test_guard_finds_dryrun_imports():
    for src in ("import repro.launch.dryrun",
                "import repro.launch.dryrun as D",
                "from repro.launch import dryrun",
                "from repro.launch import mesh, dryrun as D",
                "from repro.launch.dryrun import SHAPES",
                "def f():\n    import repro.launch.dryrun",
                "import importlib\n"
                "importlib.import_module('repro.launch.dryrun')"):
        assert dryrun_imports(src), src
    for src in ("S = 'from repro.launch import dryrun'",
                "S = \"\"\"\nimport repro.launch.dryrun\n\"\"\"",
                "from repro_torch.launch import dryrun",
                "import repro_torch.launch.dryrun",
                "from repro.launch import mesh"):
        assert not dryrun_imports(src), src


def test_no_port_test_imports_the_reference_dryrun():
    """The reference's dry-run sets XLA_FLAGS and ``layers.TP_AXIS`` when
    imported (and ``layers.MESH`` when a cell runs): in a test process it
    breaks every later reference LM call of that worker. Port tests read
    it from a subprocess only."""
    files = sorted((ROOT / "tests").glob("test_torch_*.py"))
    assert len(files) > 30
    bad = {f.name: dryrun_imports(f.read_text()) for f in files}
    assert not any(bad.values()), {k: v for k, v in bad.items() if v}
