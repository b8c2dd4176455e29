"""The port's train step against the reference's for the dense and MoE
families (granite_3_2b; qwen2_moe_a2_7b with the Sinkhorn and the top-k
router), reduced, with the reference's weights carried over by
``models/convert.py``: ``lm_loss`` (also with a padded vocabulary), loss,
ce, aux and gradients of ``grads_of`` against ``jax.value_and_grad``,
one ``make_train_step`` (metrics, updated parameters), ``remat`` on
against off, microbatches against the whole batch. Tolerances in
``_torch_train_ref``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_ref import (HP, METRIC_RTOL, assert_grads_close,
                              assert_step_matches, batch, carried, configs,
                              port_grads, ref_loss_and_grads, torch_batch)
from repro.models import model as RM
from repro.models import transformer as T
from repro.optim import adamw as RA
from repro_torch.models import model as M
from repro_torch.models.convert import from_reference
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adamw

FAMILIES = [("granite_3_2b", None), ("qwen2_moe_a2_7b", "sinkhorn"),
            ("qwen2_moe_a2_7b", "topk")]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,tp", [("granite_3_2b", 1),
                                     ("granite_3_2b", 7),
                                     ("qwen2_moe_a2_7b", 3)])
def test_lm_loss_matches_reference(arch, tp):
    """Chunked CE; tp > 1 pads the vocabulary (vp != vocab_size) and the
    padded rows are masked. The loss and its gradient in the hidden
    states within 1e-5."""
    cfg, pcfg = configs(arch)
    params = jax.tree.map(np.asarray, T.init_params(
        cfg, jax.random.PRNGKey(0), tp=tp))
    model = from_reference(pcfg, params, tp=tp, device="cpu")
    vp = model.lm_head_matrix().shape[0]
    assert (vp != cfg.vocab_size) == (tp > 1)
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 16))
    want, gh = jax.value_and_grad(
        lambda h: T.lm_loss(cfg, jax.tree.map(jnp.asarray, params), h,
                            jnp.asarray(labels)))(jnp.asarray(hidden))
    th = torch.tensor(hidden, requires_grad=True)
    got = model.lm_loss(th, torch.as_tensor(labels))
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), rtol=1e-5,
                               atol=1e-7)


def test_loss_chunk_len_matches_reference():
    from repro_torch.models.transformer import loss_chunk_len
    for t, v in ((1024, 49155), (32, 512), (4096, 151936), (7, 3), (96, 8)):
        assert loss_chunk_len(t, v) == T.loss_chunk_len(t, v)


@pytest.mark.parametrize("arch,router", FAMILIES)
def test_grads_match_reference(arch, router):
    cfg, params, model = carried(arch, router)
    bt = batch(cfg.vocab_size)
    hp = RM.TrainHParams(**HP, remat=False)
    loss, ce, aux, g = ref_loss_and_grads(cfg, params, bt, hp)
    pl, pce, paux = M.grads_of(model, torch_batch(bt),
                               M.TrainHParams(**HP, remat=False))
    for got, want in ((pl, loss), (pce, ce), (paux, aux)):
        np.testing.assert_allclose(float(got), want, rtol=METRIC_RTOL)
    assert_grads_close(port_grads(model), g)


@pytest.mark.parametrize("arch,router", FAMILIES)
def test_train_step_matches_reference(arch, router):
    cfg, params, model = carried(arch, router)
    bt = batch(cfg.vocab_size)
    pm = assert_step_matches(cfg, params, model, bt, RM.TrainHParams(**HP),
                             M.TrainHParams(**HP))
    if router:
        assert float(pm["aux"]) > 0


@pytest.mark.parametrize("arch,router", FAMILIES + [("zamba2_7b", None),
                                                    ("rwkv6_3b", None)])
def test_remat_equals_no_remat(arch, router):
    """Checkpointed recompute gives the same loss and gradients, bit for
    bit on the host."""
    _, pcfg = configs(arch, router)
    bt = torch_batch(batch(pcfg.vocab_size))
    out = []
    for remat in (False, True):
        model = Transformer(pcfg, 0, device="cpu")
        m = M.grads_of(model, bt, M.TrainHParams(**HP, remat=remat))
        out.append((m, {k: p.grad.clone() for k, p in
                        model.named_parameters()}))
    (m0, g0), (m1, g1) = out
    assert all(torch.equal(a, b) for a, b in zip(m0, m1))
    assert g0.keys() == g1.keys()
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


@pytest.mark.parametrize("arch,router", [("granite_3_2b", None),
                                         ("qwen2_moe_a2_7b", "topk")])
def test_microbatch_matches_reference_and_whole_batch(arch, router):
    """Two microbatches of 2 against the reference's microbatched step
    (metrics) and the port's whole-batch gradients. The MoE routes and
    fills its capacity per microbatch, so its whole-batch comparison is
    the dense model's only."""
    cfg, params, model = carried(arch, router)
    bt = batch(cfg.vocab_size, b=4, t=16)
    hp = RM.TrainHParams(**HP, microbatch=2)
    _, _, rm = jax.jit(RM.make_train_step(cfg, hp=hp))(
        jax.tree.map(jnp.asarray, params), RA.init(params),
        jax.tree.map(jnp.asarray, bt))
    whole = from_reference(model.cfg, params, device="cpu")
    M.grads_of(whole, torch_batch(bt), M.TrainHParams(**HP))
    pm = M.make_train_step(model, M.TrainHParams(**HP, microbatch=2))(
        adamw.init(dict(model.named_parameters())), torch_batch(bt))
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(pm[k]), float(rm[k]),
                                   rtol=METRIC_RTOL, atol=1e-7, err_msg=k)
    if router is None:
        model2 = from_reference(model.cfg, params, device="cpu")
        M.grads_of(model2, torch_batch(bt), M.TrainHParams(**HP,
                                                           microbatch=2))
        for (k, p), (_, q) in zip(model2.named_parameters(),
                                  whole.named_parameters()):
            np.testing.assert_allclose(p.grad.numpy(), q.grad.numpy(),
                                       rtol=1e-4, atol=1e-7, err_msg=k)


def test_microbatch_must_divide_the_batch():
    _, pcfg = configs("granite_3_2b")
    model = Transformer(pcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        M.grads_of(model, torch_batch(batch(pcfg.vocab_size, b=3)),
                   M.TrainHParams(microbatch=2))
