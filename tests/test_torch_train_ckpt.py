"""The port's checkpointer against the reference's
(``repro.checkpoint.checkpointer``): mirrors of its roundtrip, atomicity
and corruption tests; a ``{"params", "opt"}`` checkpoint written by the
reference after one train step restored into the port, and one written
by the port restored by the reference's ``restore``, leaves equal bit for
bit; resume-exact on the host; the training CLI with ``--ckpt-every``
and a resumed rerun, its first loss against the reference's train step
on the same weights and batch (the CLI logs 4 decimals)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_ref import batch, carried, configs, leaves, torch_batch
from repro.checkpoint import checkpointer as RC
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import batch_at_step as ref_batch_at_step
from repro.models import model as RM
from repro.optim import adamw as RA
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.models import model as M
from repro_torch.models.convert import to_reference
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    """Mirror of test_substrate.py's test."""
    state = {"params": {"w": np.arange(12.0, dtype=np.float32).reshape(3, 4),
                        "b": np.ones(4, np.float32)},
             "extra": {"step": np.asarray(7)}}
    d = str(tmp_path)
    ckpt.save(d, 7, state)
    assert ckpt.latest_step(d) == 7
    got = ckpt.restore(d, 7, state)
    np.testing.assert_array_equal(got["params"]["w"], state["params"]["w"])
    np.testing.assert_array_equal(got["params"]["b"], np.ones(4))
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert ckpt.latest_step(d) == 7           # partial writes are invisible
    ckpt.save(d, 9, state)
    assert ckpt.latest_step(d) == 9
    with open(os.path.join(d, "step_00000009", "params.npz"), "r+b") as f:
        f.seek(200)
        f.write(b"\xff\xff\xff\xff")
    with pytest.raises(Exception):
        ckpt.restore(d, 9, state)


def test_prune_old_keeps_the_newest(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, {"g": {"x": np.zeros(2)}})
    ckpt.prune_old(d, keep=3)
    assert sorted(os.listdir(d)) == [f"step_{s:08d}" for s in (3, 4, 5)]


def _ref_trained(arch="granite_3_2b", router=None):
    cfg, params, model = carried(arch, router)
    bt = batch(cfg.vocab_size)
    step = jax.jit(RM.make_train_step(cfg))
    p, o, _ = step(jax.tree.map(jnp.asarray, params), RA.init(params),
                   jax.tree.map(jnp.asarray, bt))
    return cfg, p, o, model, bt


@pytest.mark.parametrize("arch,router", [("granite_3_2b", None),
                                         ("qwen2_moe_a2_7b", "sinkhorn"),
                                         ("zamba2_7b", None)])
def test_reference_checkpoint_restores_into_port(tmp_path, arch, router):
    cfg, p, o, model, _ = _ref_trained(arch, router)
    RC.save(str(tmp_path), 1, {"params": p, "opt": o})
    opt = adamw.init(dict(model.named_parameters()))
    ckpt.load_train_state(model, opt, ckpt.restore(
        str(tmp_path), 1, ckpt.train_state(model, opt)))
    assert int(opt.step) == 1
    for got, want in ((to_reference(model), p),
                      (to_reference(model, opt.m), o.m),
                      (to_reference(model, opt.v), o.v)):
        for (k, x), (_, y) in zip(leaves(got), leaves(want)):
            np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("arch,router", [("granite_3_2b", None),
                                         ("qwen2_moe_a2_7b", "sinkhorn"),
                                         ("zamba2_7b", None)])
def test_port_checkpoint_restores_into_reference(tmp_path, arch, router):
    cfg, params, model = carried(arch, router)
    opt = adamw.init(dict(model.named_parameters()))
    M.make_train_step(model)(opt, torch_batch(batch(cfg.vocab_size)))
    ckpt.save(str(tmp_path), 1, ckpt.train_state(model, opt))
    tmpl = {"params": params, "opt": RA.init(params)}
    got = RC.restore(str(tmp_path), 1, tmpl)
    assert int(got["opt"].step) == 1
    want = ckpt.train_state(model, opt)
    for x, y in ((got["params"], want["params"]),
                 (got["opt"].m, want["opt"][".m"]),
                 (got["opt"].v, want["opt"][".v"])):
        for (k, a), (_, b) in zip(leaves(x), leaves(y)):
            np.testing.assert_array_equal(a, b, err_msg=k)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        keys = json.load(f)["groups"]["opt"]["keys"]
    assert ".step" in keys and ".m__embed" in keys
    assert ".v__final_norm__scale" in keys


def test_resume_is_exact(tmp_path):
    """Save after 2 steps, restore into a fresh model and state, 2 more
    steps: the parameters equal 4 uninterrupted steps bit for bit."""
    pcfg = configs("granite_3_2b")[1]
    hp = M.TrainHParams(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    bts = [torch_batch(batch(pcfg.vocab_size, seed=s)) for s in range(4)]

    def fresh():
        model = Transformer(pcfg, 0, device="cpu")
        return model, adamw.init(dict(model.named_parameters()))
    a, oa = fresh()
    step = M.make_train_step(a, hp)
    for bt in bts:
        step(oa, bt)
    b, ob = fresh()
    step = M.make_train_step(b, hp)
    for bt in bts[:2]:
        step(ob, bt)
    ckpt.save(str(tmp_path), 2, ckpt.train_state(b, ob))
    c, oc = fresh()
    ckpt.load_train_state(c, oc, ckpt.restore(str(tmp_path), 2,
                                              ckpt.train_state(c, oc)))
    step = M.make_train_step(c, hp)
    for bt in bts[2:]:
        step(oc, bt)
    for (k, p), (_, q) in zip(a.named_parameters(), c.named_parameters()):
        assert torch.equal(p, q), k
    assert all(torch.equal(oa.m[k], oc.m[k]) for k in oa.m)
    assert int(oc.step) == 4


def _cli(*argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *argv], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.splitlines()


def test_train_cli_checkpoints_and_resumes(tmp_path):
    d = str(tmp_path / "run")
    base = ["--arch", "granite_3_2b", "--reduced", "--ckpt-dir", d,
            "--ckpt-every", "3", "--device", "cpu", "--log-every", "1",
            "--seq-len", "32", "--global-batch", "2"]
    lines = _cli(*base, "--steps", "6")
    recs = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert [r["step"] for r in recs] == list(range(6))
    assert sum(ln.startswith("checkpoint:") for ln in lines) == 2
    assert ckpt.latest_step(d) == 6
    # the first loss: the reference's train step on the port's initial
    # weights (seed 0 on the host) and batch_at_step(0)
    cfg, pcfg = configs("granite_3_2b")
    model = Transformer(pcfg, torch.Generator("cpu").manual_seed(0),
                        device="cpu")
    params = to_reference(model)
    hp = RM.TrainHParams(peak_lr=3e-4, warmup_steps=5, total_steps=6)
    bt = ref_batch_at_step(RefDataConfig(cfg.vocab_size, 2, 32, 0), 0)
    _, _, rm = jax.jit(RM.make_train_step(cfg, hp=hp))(
        jax.tree.map(jnp.asarray, params), RA.init(params), bt)
    assert abs(recs[0]["loss"] - float(rm["loss"])) <= 1e-4
    assert abs(recs[0]["grad_norm"] - float(rm["grad_norm"])) <= 1e-3
    np.testing.assert_allclose(recs[0]["lr"], float(rm["lr"]), rtol=1e-6)
    lines = _cli(*base, "--steps", "8")
    assert lines[0] == "resumed from step 6"
    recs2 = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert [r["step"] for r in recs2] == [6, 7]
    assert all(np.isfinite(r["loss"]) for r in recs + recs2)


def test_train_cli_without_a_card_refuses():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--arch", "granite_3_2b", "--reduced", "--steps",
                          "1"], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and "CUDA" in out.stderr


def test_non_finite_loss_is_a_poison_step(monkeypatch):
    """A NaN loss stops the run with SystemExit naming the step."""
    from repro_torch.launch import train as train_cli

    def poisoned(model, hp):
        def step(opt, batch):
            nan = torch.tensor(float("nan"))
            return {"loss": nan, "ce": nan, "aux": nan, "grad_norm": nan,
                    "lr": nan}
        return step
    monkeypatch.setattr(train_cli.M, "make_train_step", poisoned)
    args = train_cli.build_parser().parse_args(
        ["--arch", "granite_3_2b", "--reduced", "--steps", "2",
         "--device", "cpu", "--seq-len", "8", "--global-batch", "2"])
    with pytest.raises(SystemExit, match="poison step at 0"):
        train_cli.run(args)
