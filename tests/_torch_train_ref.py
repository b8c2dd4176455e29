"""Shared fixtures of the train-step parity tests: the reduced config of
an arch (with a router), the reference's weights carried into the port,
one batch, and the reference's loss, gradients and train step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config
from repro.models import model as RM
from repro.models import transformer as T
from repro.optim import adamw as RA
from repro_torch.configs.base import get_config as port_config
from repro_torch.models import model as M
from repro_torch.models.convert import from_reference, to_reference
from repro_torch.optim import adamw

B, SEQ = 2, 32
HP = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
# metrics within 1e-5 relative; each gradient leaf within 1e-4 of its
# largest entry (measured worst: 1.1e-5 of it, zamba2)
METRIC_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-4, 1e-4
# AdamW's first update is lr * g / (|g| + eps): +-lr wherever |g| >> eps,
# so a gradient entry within rounding of zero can flip an entry's update
# by up to 2 lr between the packages. Entries outside PARAM_TOL must have
# such a gradient (|g| < G_ZERO after the clip) and stay within 2 lr.
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
G_ZERO = 1e-6


def configs(arch: str, router=None):
    cfg, pcfg = get_config(arch).reduced(), port_config(arch).reduced()
    if router:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, router=router))
        pcfg = dataclasses.replace(
            pcfg, moe=dataclasses.replace(pcfg.moe, router=router))
    return cfg, pcfg


def carried(arch: str, router=None, seed: int = 0):
    """(reference cfg, reference params as numpy, port model on the CPU)
    holding the same weights."""
    cfg, pcfg = configs(arch, router)
    params = jax.tree.map(np.asarray, T.init_params(
        cfg, jax.random.PRNGKey(seed)))
    return cfg, params, from_reference(pcfg, params, device="cpu")


def batch(vocab: int, seed: int = 1, b: int = B, t: int = SEQ) -> dict:
    tok = np.random.default_rng(seed).integers(0, vocab, (b, t + 1))
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def torch_batch(bt: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in bt.items()}


def ref_loss_and_grads(cfg, params, bt, hp, remat=False):
    def loss_fn(p):
        hidden, aux = T.forward(cfg, p, jnp.asarray(bt["tokens"]),
                                remat=remat)
        ce = T.lm_loss(cfg, p, hidden, jnp.asarray(bt["labels"]))
        return ce + hp.aux_loss_weight * aux.astype(jnp.float32), (ce, aux)
    (loss, (ce, aux)), g = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    return float(loss), float(ce), float(aux), g


def ref_step(cfg, params, bt, hp):
    step = jax.jit(RM.make_train_step(cfg, hp=hp))
    return step(jax.tree.map(jnp.asarray, params), RA.init(params),
                jax.tree.map(jnp.asarray, bt))


def port_grads(model) -> dict:
    return to_reference(model, {k: p.grad for k, p in
                                model.named_parameters()})


def leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def assert_grads_close(got: dict, want: dict) -> None:
    got_l, want_l = leaves(got), leaves(want)
    assert [k for k, _ in got_l] == [k for k, _ in want_l]
    for (name, x), (_, y) in zip(got_l, want_l):
        np.testing.assert_allclose(
            x, y, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_SHARE * float(np.abs(y).max()), err_msg=name)


def assert_step_matches(cfg, params, model, bt, hp, phps):
    """One make_train_step on each side: metrics, then the parameters
    under the rule above."""
    g = ref_loss_and_grads(cfg, params, bt, hp, remat=hp.remat)[3]
    new_p, new_opt, rm = ref_step(cfg, params, bt, hp)
    opt = adamw.init(dict(model.named_parameters()))
    pm = M.make_train_step(model, phps)(opt, torch_batch(bt))
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(pm[k]), float(rm[k]),
                                   rtol=METRIC_RTOL, atol=1e-7, err_msg=k)
    assert int(opt.step) == int(new_opt.step) == 1
    scale = min(1.0, hp.clip_norm / max(float(rm["grad_norm"]), 1e-12))
    lr = float(rm["lr"])
    for (name, x), (_, y), (_, gr) in zip(leaves(to_reference(model)),
                                          leaves(new_p), leaves(g)):
        bad = ~np.isclose(x, y, **PARAM_TOL)
        assert np.all(np.abs(gr[bad] * scale) < G_ZERO), name
        assert np.all(np.abs(x - y) <= 2 * lr * (1 + 1e-5) + 1e-6), name
    return pm
