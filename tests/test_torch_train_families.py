"""The port's train step for the SSM and hybrid families (rwkv6_3b,
zamba2_7b, reduced) against the reference's: loss, ce, gradients and one
``make_train_step`` with the reference's weights carried over (tolerances
in ``_torch_train_ref``); one port step for every one of the ten
architectures (finite, parameters moved); a mirror of the reference's
tiny-overfit integration test."""
import numpy as np
import pytest
import torch

from _torch_train_ref import (HP, METRIC_RTOL, assert_grads_close,
                              assert_step_matches, batch, carried, configs,
                              port_grads, ref_loss_and_grads, torch_batch)
from repro.configs.base import ARCH_IDS
from repro.models import model as RM
from repro_torch.models import model as M
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adamw


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["rwkv6_3b", "zamba2_7b"])
def test_grads_match_reference(arch):
    cfg, params, model = carried(arch)
    bt = batch(cfg.vocab_size)
    hp = RM.TrainHParams(**HP, remat=False)
    loss, ce, _, g = ref_loss_and_grads(cfg, params, bt, hp)
    pl, pce, paux = M.grads_of(model, torch_batch(bt),
                               M.TrainHParams(**HP, remat=False))
    np.testing.assert_allclose(float(pl), loss, rtol=METRIC_RTOL)
    np.testing.assert_allclose(float(pce), ce, rtol=METRIC_RTOL)
    assert float(paux) == 0.0
    assert_grads_close(port_grads(model), g)


@pytest.mark.parametrize("arch", ["rwkv6_3b", "zamba2_7b"])
def test_train_step_matches_reference(arch):
    cfg, params, model = carried(arch)
    assert_step_matches(cfg, params, model, batch(cfg.vocab_size),
                        RM.TrainHParams(**HP), M.TrainHParams(**HP))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_one_step_every_arch(arch):
    """Mirror of test_arch_smoke.py::test_forward_and_train_step on the
    port alone: finite metrics, the step counted, every family's
    parameters moved."""
    _, pcfg = configs(arch)
    model = Transformer(pcfg, 0, device="cpu")
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = adamw.init(dict(model.named_parameters()))
    m = M.make_train_step(model, M.TrainHParams())(
        opt, torch_batch(batch(pcfg.vocab_size, seed=4)))
    assert all(np.isfinite(float(m[k])) for k in m)
    assert int(opt.step) == 1
    moved = [k for k, p in model.named_parameters()
             if not torch.equal(p, before[k])]
    assert len(moved) == len(before)


def test_loss_decreases_tiny_overfit():
    """Mirror of test_arch_smoke.py: 30 steps on one repeated batch cut
    the ce below 0.7 of the first."""
    _, pcfg = configs("granite_3_2b")
    model = Transformer(pcfg, 0, device="cpu")
    rng = np.random.default_rng(1)
    tok = torch.as_tensor(rng.integers(0, pcfg.vocab_size, (2, 32)))
    bt = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    step = M.make_train_step(model, M.TrainHParams(
        peak_lr=1e-3, warmup_steps=5, total_steps=50))
    opt = adamw.init(dict(model.named_parameters()))
    first = None
    for _ in range(30):
        m = step(opt, bt)
        first = float(m["ce"]) if first is None else first
    assert float(m["ce"]) < 0.7 * first, (first, float(m["ce"]))
