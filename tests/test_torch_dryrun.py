"""The port's dry-run and roofline accounting against the reference's.

The reference's dry-run module sets process-wide state when it is
imported (``XLA_FLAGS`` for 512 host devices, ``layers.TP_AXIS``) and
when a cell runs (``layers.MESH``, ``layers.DP_AXES``, the sharding
module's axis sizes): after that, a reference LM call in the same process
raises. So its helpers are read from ONE subprocess (``python -c``, with
``XLA_FLAGS`` popped from the child's environment and set inside its
script), as ``tests/test_dryrun_unit.py`` runs it; no test process
imports it (``tests/test_torch_imports.py`` guards this). The
reference's ``runtime/analysis.py`` sets no global, and runs here in
process.

Tolerances: the helpers, ``analytic_hbm_bytes`` and ``roofline_terms``
exactly; prefill's matmul FLOPs within 1% of the reference's contracting
``dot_general`` FLOPs (JAX lowers an einsum's pure elementwise products
to ``dot_general``s that contract no dim; the port computes those as
elementwise ops, counted at one FLOP an element); a train step's total
within the reference's own band of 0.8-4x 6*N*D (``test_dryrun_unit.py``)
and, for the attention families without remat, its matmul FLOPs within 1%
of the reference's (the SSM scans' einsum products, elementwise in the
port, have contracting transposes in the reference's backward); the depth
extrapolation equal to a direct walk within 1e-6 relative (the aux
losses' scalar bookkeeping is not linear in the depth)."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS, get_config as ref_config
from repro.models import model as RM
from repro.models import transformer as RT
from repro.runtime import analysis as RA
from repro_torch.configs.base import get_config
from repro_torch.launch import dryrun as TD
from repro_torch.models.model import TrainHParams, grads_of, make_prefill
from repro_torch.models.transformer import Transformer
from repro_torch.runtime import analysis as TA
from repro_torch.runtime.sharding import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATMULS = ("mm", "bmm", "addmm", "baddbmm")
DOT_TOL = 0.01
BAND = (0.8, 4.0)
WALK_RTOL = 1e-6
B, T = 2, 64
FAMILIES = ["granite_3_2b", "qwen2_moe_a2_7b", "rwkv6_3b", "zamba2_7b"]

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import json
    from repro.configs.base import ARCH_IDS, get_config
    from repro.launch import dryrun as D
    out = {"shapes": D.SHAPES, "tp": D.TP, "applicable": {}, "fsdp": {},
           "microbatch": {}, "model_flops": {}}
    for a in ARCH_IDS:
        cfg = get_config(a)
        out["fsdp"][a] = D.needs_fsdp(cfg)
        for s, sh in D.SHAPES.items():
            key = a + "/" + s
            out["applicable"][key] = list(D.cell_is_applicable(a, s))
            out["model_flops"][key] = D.model_flops_for(
                cfg, sh["kind"], sh["gb"], sh["seq"])
            for ds in (8, 16, 32, 64):
                out["microbatch"][key + "/" + str(ds)] = D.pick_microbatch(
                    cfg, sh["gb"], sh["seq"], ds)
    print("DRYRUN_HELPERS " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_helpers():
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", REFERENCE], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("DRYRUN_HELPERS ")]
    assert line, res.stdout + res.stderr
    return json.loads(line[0].split(" ", 1)[1])


def test_dryrun_helpers_match_reference(reference_helpers):
    """SHAPES, cell_is_applicable, needs_fsdp and pick_microbatch at the
    reference's budgets (tp 16, 8e9; 3e9), model_flops_for: every arch x
    shape."""
    ref = reference_helpers
    assert json.loads(json.dumps(TD.SHAPES)) == ref["shapes"]
    for a in ARCH_IDS:
        cfg = get_config(a)
        assert TD.needs_fsdp(cfg, tp=ref["tp"], budget_bytes=8e9) \
            == ref["fsdp"][a], a
        for s, sh in TD.SHAPES.items():
            key = f"{a}/{s}"
            assert list(TD.cell_is_applicable(a, s)) == ref["applicable"][key]
            assert TD.model_flops_for(cfg, sh["kind"], sh["gb"], sh["seq"]) \
                == ref["model_flops"][key]
            for ds in (8, 16, 32, 64):
                assert TD.pick_microbatch(cfg, sh["gb"], sh["seq"], ds,
                                          budget_bytes=3e9) \
                    == ref["microbatch"][f"{key}/{ds}"], (key, ds)
    n_skip = sum(not v[0] for v in ref["applicable"].values())
    assert n_skip == 8          # long_500k of the eight attention archs


def test_analytic_hbm_bytes_and_roofline_match_reference():
    for a in ARCH_IDS:
        for kind, (gb, seq) in (("train", (256, 4096)),
                                ("prefill", (32, 32768)),
                                ("decode", (128, 32768)),
                                ("decode", (1, 524288))):
            for n_chips, tp in ((256, 16), (512, 16), (256, 8), (512, 8)):
                want = RA.analytic_hbm_bytes(ref_config(a), kind, gb, seq,
                                             n_chips, tp)
                got = TA.analytic_hbm_bytes(get_config(a), kind, gb, seq,
                                            n_chips, tp)
                assert got == want, (a, kind, n_chips, tp)
    hw = {"peak_flops_bf16": RA.HW["peak_flops_bf16"],
          "hbm_bw": RA.HW["hbm_bw"], "link_bw": RA.HW["ici_bw"]}
    for args in ((3.1e17, 2.2e15, 4.5e10, 256, 1.6e17),
                 (1e12, 5e14, 1e6, 512, 4e11), (0.0, 0.0, 0.0, 256, 0.0)):
        assert TA.roofline_terms(*args, hw=hw) == RA.roofline_terms(*args)


def _matmul_flops(cost) -> float:
    return sum(v for k, v in cost.by_op.items() if k in MATMULS)


def _contracting_dots(jaxpr, mult: int = 1) -> int:
    """FLOPs of the dot_generals that contract a dim, scans multiplied
    through (the reference walker's rule)."""
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "scan":
            total += _contracting_dots(eqn.params["jaxpr"].jaxpr,
                                       mult * eqn.params["length"])
        elif name == "cond":
            total += sum(_contracting_dots(br.jaxpr, mult)
                         for br in eqn.params["branches"])
        elif name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            if lc:
                k = int(np.prod([eqn.invars[0].aval.shape[d] for d in lc]))
                total += mult * 2 * int(np.prod(eqn.outvars[0].aval.shape)) * k
        else:
            for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                inner = eqn.params.get(key)
                if inner is not None:
                    total += _contracting_dots(getattr(inner, "jaxpr", inner),
                                               mult)
                    break
    return total


def _meta_tokens():
    return torch.zeros((B, T), dtype=torch.long, device="meta")


@pytest.mark.parametrize("arch", FAMILIES)
def test_torch_cost_prefill_matmuls_match_reference_dots(arch):
    jcfg = ref_config(arch).reduced()
    closed = jax.make_jaxpr(RM.make_prefill(jcfg))(
        RM.abstract_params(jcfg), jax.ShapeDtypeStruct((B, T), jnp.int32))
    model = Transformer(get_config(arch).reduced(), device="meta")
    with torch.no_grad():
        cost = TA.torch_cost(make_prefill(model), _meta_tokens())
    want = _contracting_dots(closed.jaxpr)
    assert abs(_matmul_flops(cost) / want - 1) < DOT_TOL, \
        (_matmul_flops(cost), want)
    total = RA.jaxpr_cost(RM.make_prefill(jcfg), RM.abstract_params(jcfg),
                          jax.ShapeDtypeStruct((B, T), jnp.int32))["flops"]
    assert 0.5 < cost.flops / total < 1.5


@pytest.mark.parametrize("arch", FAMILIES)
def test_torch_cost_train_within_reference_band(arch):
    """The train step's total against 6*N*D (both sides inside the band);
    for the attention families, without remat, the gradient's matmuls
    equal the reference's contracting dots. With remat the port
    recomputes one layer fewer per remat group (torch's checkpoint stops
    its recompute once the group's saved tensors are back; the group's
    last layer produces none)."""
    cfg, jcfg = get_config(arch).reduced(), ref_config(arch).reduced()
    ap = RM.abstract_params(jcfg)
    batch = RM.train_input_specs(jcfg, B, T)
    ref = RA.jaxpr_cost(RM.make_train_step(jcfg), ap,
                        RM.abstract_opt_state(ap), batch)
    walk = TD.train_walk(B, T, 1, None, TrainHParams())
    got = walk(cfg)
    six_nd = 6 * cfg.n_params() * B * T
    for flops in (ref["flops"], got.flops):
        assert BAND[0] < flops / six_nd < BAND[1], (flops, six_nd)
    if cfg.ssm:
        return

    def loss(p, t, lab):
        h, _ = RT.forward(jcfg, p, t, remat=False)
        return RT.lm_loss(jcfg, p, h, lab)
    tok = jax.ShapeDtypeStruct((B, T), jnp.int32)
    closed = jax.make_jaxpr(jax.value_and_grad(loss))(ap, tok, tok)
    model = Transformer(cfg, device="meta")
    t = _meta_tokens()
    plain = TA.torch_cost(lambda m: grads_of(
        m, {"tokens": t, "labels": t}, TrainHParams(remat=False,
                                                    aux_loss_weight=0.0)),
        model)
    want = _contracting_dots(closed.jaxpr)
    assert abs(_matmul_flops(plain) / want - 1) < DOT_TOL, \
        (_matmul_flops(plain), want)


@pytest.mark.parametrize("arch,layers", [("granite_3_2b", 7),
                                         ("qwen2_moe_a2_7b", 3),
                                         ("rwkv6_3b", 6), ("zamba2_7b", 7)])
def test_stacked_cost_equals_direct_walk(arch, layers):
    """Walking four small depths and extrapolating gives the full walk's
    FLOPs, major bytes and counted collectives (train with remat, and
    prefill); the MoE with its experts dealt over a (2, 4) mesh of meta
    positions."""
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=layers)
    mesh = make_mesh((2, 4), ("data", "model"), ["meta"]) if cfg.moe \
        else None
    for walk, remat in ((TD.train_walk(B, T, 2, mesh, TrainHParams()), True),
                        (TD.prefill_walk(B, T, mesh), False)):
        direct = walk(cfg)
        got = TA.stacked_cost(cfg, walk, remat)
        for k in ("flops", "major_bytes", "collective_calls",
                  "collective_bytes"):
            a, b = getattr(got, k), getattr(direct, k)
            assert abs(a - b) <= WALK_RTOL * b, (k, a, b)
    if mesh is not None:        # one psum a MoE layer in a prefill
        assert direct.collective_calls == layers


def test_analytic_collectives_terms():
    cfg = get_config("granite_3_2b")
    one = TA.analytic_collective_bytes(cfg, "train", 256, 4096, 8, 1, False)
    assert one["per_term_bytes"]["tp_activations"] == 0
    assert one["total_bytes"] == cfg.n_params() * 4      # dp gradients
    tp8 = TA.analytic_collective_bytes(cfg, "decode", 128, 32768, 256, 8,
                                       False)["per_term_bytes"]
    assert tp8["tp_activations"] == 2 * cfg.num_layers * 4 * cfg.d_model * 2
    assert tp8["dp_gradients"] == 0 and tp8["fsdp_gathers"] == 0
    hyb = get_config("zamba2_7b")
    assert TA.tp_allreduces_per_pass(hyb) == 81 + 2 * 13


def test_dryrun_cli_writes_a_cell(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "granite_3_2b", "--shape", "train_4k", "--mesh", "single",
           "--out-dir", str(tmp_path)]
    out = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    cell = json.loads((tmp_path / "granite_3_2b__train_4k__single.json")
                      .read_text())
    assert cell["fits_80gb"] is True and cell["mesh"] == "32x8"
    assert cell["n_chips"] == 256 and cell["torch_cost"]["flops"] > 0
    for k in ("compute_s", "memory_s", "collective_s"):
        assert cell["roofline"][k] > 0
    assert cell["roofline"]["dominant"] in ("compute", "memory",
                                            "collective")
    assert cell["build_s"] >= 0 and cell["walk_s"] > 0
    assert 0.3 < cell["roofline"]["useful_ratio"] <= 1.0


R12 = textwrap.dedent("""
    import os
    os.environ.pop("XLA_FLAGS", None)
    import jax, jax.numpy as jnp
    from repro.configs.base import get_config
    from repro.models import transformer as T
    cfg = get_config("granite_3_2b").reduced()
    params = T.init_params(cfg, jax.random.PRNGKey(0))
    tok = jnp.zeros((1, 8), jnp.int32)
    T.forward(cfg, params, tok)
    print("R12_BEFORE_OK")
    import repro.launch.dryrun
    try:
        T.forward(cfg, params, tok)
    except RuntimeError as e:
        print("R12_RAISES", str(e).splitlines()[0][:200])
    else:
        print("R12_RUNS")
""")


def test_r12_reference_dryrun_import_breaks_lm_forward():
    """ROADMAP R12, in a subprocess: the reference's LM forward runs, and
    after ``import repro.launch.dryrun`` (which sets ``layers.TP_AXIS``)
    the same call raises for want of a mesh. Why no test process may
    import it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", R12], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert "R12_BEFORE_OK" in res.stdout, res.stdout + res.stderr
    assert "R12_RAISES" in res.stdout and "mesh" in res.stdout, \
        res.stdout + res.stderr
