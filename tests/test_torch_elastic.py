"""The port's elastic meshes and production meshes.

``elastic_mesh`` and ``scaled_global_batch`` against the reference's on a
grid of explicit arguments, read from ONE reference subprocess that prints
JSON: the reference builds ``jax.make_mesh`` over up to 512 host devices,
which needs ``XLA_FLAGS`` set before JAX starts (popped from the child's
environment and set inside its script), so no test process builds it.
Shapes and axis names compare exactly; a refused device count raises
ValueError on both sides."""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.launch.mesh import make_dev_mesh, make_production_mesh
from repro_torch.runtime.fault_tolerance import (elastic_mesh,
                                                 scaled_global_batch)
from repro_torch.runtime.sharding import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = [(n, mp, pod) for n in (8, 16, 48, 64, 128, 240, 256, 384, 512)
        for mp in (8, 16) for pod in (128, 256)]
BATCH = [(b, base, live, keep) for b in (256, 1000) for base in (32, 64)
         for live in (7, 31, 32, 40) for keep in (True, False)]

REFERENCE = textwrap.dedent(f"""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import json
    from repro.runtime.fault_tolerance import (elastic_mesh,
                                               scaled_global_batch)
    meshes = []
    for n, mp, pod in {GRID!r}:
        try:
            m = elastic_mesh(n, mp, pod)
            meshes.append([list(m.devices.shape), list(m.axis_names)])
        except ValueError:
            meshes.append(None)
    batches = [scaled_global_batch(*a) for a in {BATCH!r}]
    print("ELASTIC " + json.dumps({{"meshes": meshes, "batches": batches}}))
""")


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", REFERENCE], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("ELASTIC ")]
    assert line, res.stdout + res.stderr
    return json.loads(line[0].split(" ", 1)[1])


def test_elastic_mesh_matches_reference(reference):
    assert sum(m is None for m in reference["meshes"]) > 0
    for (n, mp, pod), want in zip(GRID, reference["meshes"]):
        if want is None:
            with pytest.raises(ValueError):
                elastic_mesh(n, mp, pod, devices=["cpu"])
            continue
        got = elastic_mesh(n, mp, pod, devices=["cpu"])
        assert [list(got.shape), list(got.axis_names)] == want, (n, mp, pod)
        assert got.size == n and set(got.devices) == {torch.device("cpu")}


def test_scaled_global_batch_matches_reference(reference):
    assert [scaled_global_batch(*a) for a in BATCH] == reference["batches"]


def test_meshes_deal_devices_and_refuse_without_a_card():
    single = make_production_mesh(devices=["meta"])
    multi = make_production_mesh(multi_pod=True, devices=["meta"])
    assert (single.shape, single.axis_names) == ((32, 8), ("data", "model"))
    assert (multi.shape, multi.axis_names) == ((2, 32, 8),
                                               ("pod", "data", "model"))
    assert (single.size, multi.size) == (256, 512)
    dev = make_dev_mesh(8, tp=4, devices=["cpu"])
    assert dev.shape == (2, 4)
    with pytest.raises(ValueError):
        make_dev_mesh(6, tp=4, devices=["cpu"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default devices are valid")
    for build in (lambda: make_mesh((2, 4), ("data", "model")),
                  lambda: elastic_mesh(16),
                  lambda: make_production_mesh(),
                  lambda: make_dev_mesh()):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
