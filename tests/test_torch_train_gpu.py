"""The port's training path on the card against the host. Marked ``gpu``:
each test skips, from inside, when no CUDA device is present. Imports
nothing of JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_gpu.py
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, batch_at_step
from repro_torch.launch import train as train_cli
from repro_torch.models.model import TrainHParams, make_train_step
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adamw

HP = TrainHParams(peak_lr=1e-3, warmup_steps=2, total_steps=10)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cfg(arch, router=None):
    cfg = get_config(arch).reduced()
    if router:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, router=router))
    return cfg


def _steps(model, steps):
    dc = DataConfig(model.cfg.vocab_size, 4, 32)
    opt = adamw.init(dict(model.named_parameters()))
    step = make_train_step(model, HP)
    for i in steps:
        m = step(opt, batch_at_step(dc, i))
    return opt, {k: float(v) for k, v in m.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("arch,router", [
    ("granite_3_2b", None), ("qwen2_moe_a2_7b", "sinkhorn"),
    ("qwen2_moe_a2_7b", "topk"), ("rwkv6_3b", None), ("zamba2_7b", None)])
def test_train_step_on_card_matches_host(arch, router):
    """One step: metrics within 1e-5 relative, each clipped gradient leaf
    within 1e-4 of its largest entry."""
    dev = _card()
    host = Transformer(_cfg(arch, router), 0, device="cpu")
    card = copy.deepcopy(host).to(dev)
    _, mh = _steps(host, range(1))
    _, mc = _steps(card, range(1))
    for k in mh:
        np.testing.assert_allclose(mc[k], mh[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for (name, ph), pc in zip(host.named_parameters(), card.parameters()):
        torch.testing.assert_close(
            pc.grad.cpu(), ph.grad, rtol=1e-4,
            atol=1e-4 * float(ph.grad.abs().max()))


@pytest.mark.gpu
def test_resume_on_card_is_exact(tmp_path):
    dev = _card()
    cfg = _cfg("granite_3_2b")
    whole = Transformer(cfg, 0, device=dev)
    _steps(whole, range(4))
    first = Transformer(cfg, 0, device=dev)
    opt, _ = _steps(first, range(2))
    ckpt.save(str(tmp_path), 2, ckpt.train_state(first, opt))
    resumed = Transformer(cfg, 1, device=dev)
    opt_r = adamw.init(dict(resumed.named_parameters()))
    ckpt.load_train_state(resumed, opt_r, ckpt.restore(
        str(tmp_path), 2, ckpt.train_state(resumed, opt_r)))
    step = make_train_step(resumed, HP)
    for i in (2, 3):
        step(opt_r, batch_at_step(DataConfig(cfg.vocab_size, 4, 32), i))
    for a, b in zip(whole.parameters(), resumed.parameters()):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_train_cli_run_on_card(tmp_path):
    _card()
    args = train_cli.build_parser().parse_args(
        ["--arch", "qwen2_moe_a2_7b", "--reduced", "--steps", "4",
         "--log-every", "1", "--seq-len", "32", "--ckpt-dir", str(tmp_path),
         "--ckpt-every", "2"])
    recs = train_cli.run(args)
    assert [r["step"] for r in recs] == [0, 1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert ckpt.latest_step(str(tmp_path)) == 4
