"""Expert slices held once per device (``models.moe.MoE.held``): with grad
off, a position on another device than the weights gets each slice (the
routed experts', the shared expert's ff slice, the router weight) copied
once and reused while its source is unchanged; in grad mode it is copied
on every call, so gradients reach the stacked weights.

The host has one real device. A device other than the weights' is shown
two ways: positions on ``meta`` against weights on ``cpu`` (shapes only:
enough to count copies), and a ``cpu`` mesh with ``moe._moves`` made to
copy on its own device too (values: logits, in-place updates, gradients)."""
import copy
import dataclasses
import gc
import weakref

import pytest
import torch

from repro_torch.configs.base import MoESpec, get_config
from repro_torch.models import moe as TM
from repro_torch.models.model import (TrainHParams, grads_of,
                                      make_serve_step)
from repro_torch.models.transformer import Transformer
from repro_torch.runtime import sharding as TS

E, D, FF, K, TP = 8, 32, 16, 2, 4
# slices a device holds for one MoE layer at tp 4: three routed and three
# shared per model index, and the router
PER_LAYER = TP * 6 + 1


def _layer(n_shared: int = 1) -> TM.MoE:
    spec = MoESpec(n_experts=E, n_shared=n_shared, top_k=K, d_ff=FF,
                   router="topk", capacity_factor=8.0)
    return TM.MoE(D, spec, torch.Generator().manual_seed(0), tp=TP,
                  device="cpu")


def _mesh(dev: str = "cpu", shape=(2, TP)):
    return TS.make_mesh(shape, ("data", "model"), [dev])


@pytest.fixture()
def other_device(monkeypatch):
    """Slices copy (counted, and held with grad off) on the weights' own
    device too, as they do for another device."""
    monkeypatch.setattr(TM, "_moves", lambda w, dev: True)


@pytest.mark.parametrize("n_shared", [1, 0])
def test_second_call_copies_nothing_on_meta_positions(n_shared):
    """Weights on cpu, positions on meta: the first call with grad off
    copies each slice once, the second none; grad mode copies every call
    and holds nothing."""
    layer = _layer(n_shared)
    x = torch.zeros((4, 8, D), device="meta")
    mesh = _mesh("meta")
    per_layer = TP * (3 + 3 * n_shared) + 1
    with torch.no_grad():
        c0 = TM.slice_copies()
        out, _ = TM.moe_apply_ep(layer, x, mesh)
        c1 = TM.slice_copies()
        TM.moe_apply_ep(layer, x, mesh)
        c2 = TM.slice_copies()
    assert out.shape == x.shape and out.device.type == "meta"
    assert (c1 - c0, c2 - c1) == (per_layer, 0)
    assert len(layer._held) == per_layer
    assert all(h[2].device.type == "meta" for h in layer._held.values())
    fresh = _layer(n_shared)
    for _ in range(2):
        c0 = TM.slice_copies()
        TM.moe_apply_ep(fresh, x, mesh)
        assert TM.slice_copies() - c0 == per_layer
    assert fresh._held == {}


def test_views_on_the_weights_device_copy_nothing():
    layer = _layer()
    x = torch.randn((4, 8, D), generator=torch.Generator().manual_seed(1))
    c0 = TM.slice_copies()
    with torch.no_grad():
        TM.moe_apply_ep(layer, x, _mesh())
    assert TM.slice_copies() == c0
    assert layer._held == {}


def test_inference_tensors_are_held_and_reassignment_is_seen():
    """A layer built under inference mode (as the server builds its model)
    has no version counters: its slices are held all the same, and a
    reassigned parameter is copied afresh."""
    with torch.inference_mode():
        layer = _layer()
    x = torch.zeros((4, 8, D), device="meta")
    mesh = _mesh("meta")
    with torch.inference_mode():
        c0 = TM.slice_copies()
        TM.moe_apply_ep(layer, x, mesh)
        TM.moe_apply_ep(layer, x, mesh)
        assert TM.slice_copies() - c0 == PER_LAYER
        layer.w_gate = torch.nn.Parameter(layer.w_gate * 2.0)
        c0 = TM.slice_copies()
        TM.moe_apply_ep(layer, x, mesh)
        assert TM.slice_copies() - c0 == TP


def test_load_state_dict_is_seen_under_inference_mode(other_device):
    """An inference-mode layer tracks no versions; a ``load_state_dict``
    (in place, as copy_) drops its held slices all the same."""
    with torch.inference_mode():
        layer = _layer()
    x = torch.randn((4, 8, D), generator=torch.Generator().manual_seed(4))
    mesh = _mesh()
    state = {k: v * 0.5 for k, v in _layer().state_dict().items()}
    with torch.inference_mode():
        before, _ = TM.moe_apply_ep(layer, x, mesh)
        layer.load_state_dict(state)
        c0 = TM.slice_copies()
        after, _ = TM.moe_apply_ep(layer, x, mesh)
        assert TM.slice_copies() - c0 == PER_LAYER
        fresh = _layer()
        fresh.load_state_dict(state)
        want, _ = TM.moe_apply_ep(fresh, x, mesh)
    assert not torch.equal(after, before)
    assert torch.equal(after, want)


def test_a_device_holds_one_tp_and_no_old_weights():
    """A mesh of another tp drops the device's slices of the old one, and
    a reassigned parameter is not kept alive by its held copies."""
    layer = _layer()
    x = torch.zeros((4, 8, D), device="meta")
    with torch.no_grad():
        TM.moe_apply_ep(layer, x, _mesh("meta"))
        TM.moe_apply_ep(layer, x, _mesh("meta", (4, 2)))
    assert len(layer._held) == 2 * 6 + 1
    assert {k[1][-1] for k in layer._held} == {2}
    old = weakref.ref(layer.w_up)
    layer.w_up = torch.nn.Parameter(layer.w_up.detach() * 2.0)
    gc.collect()
    assert old() is None


def _qwen(router: str = "sinkhorn"):
    cfg = get_config("qwen2_moe_a2_7b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router=router))


def test_held_logits_equal_per_call_path(other_device):
    """The reduced qwen2_moe over a (2, 4) cpu mesh: 6 serve steps with
    grad off (each layer's slices copied at the first step, none after)
    against the same tokens in grad mode (copied every step), bit for
    bit."""
    cfg = _qwen()
    model = Transformer(cfg, 0, device="cpu")
    step = make_serve_step(model, _mesh())
    n_moe = cfg.num_layers
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (4, 6), generator=gen)

    def run(mode):
        cache = model.init_cache(4, 6)
        logits, copies = [], []
        for t in range(6):
            c0 = TM.slice_copies()
            with mode():
                _, lg, cache = step(cache, tokens[:, t:t + 1])
            copies.append(TM.slice_copies() - c0)
            logits.append(lg.detach())
        return torch.stack(logits, 1), copies

    held, held_copies = run(torch.inference_mode)
    per_call, call_copies = run(torch.enable_grad)
    assert held_copies == [n_moe * PER_LAYER] + [0] * 5
    assert call_copies == [n_moe * PER_LAYER] * 6
    assert torch.isfinite(held).all()
    assert torch.equal(held, per_call)


def test_in_place_update_is_seen_by_the_next_call(other_device):
    layer = _layer()
    x = torch.randn((4, 8, D), generator=torch.Generator().manual_seed(3))
    mesh = _mesh()
    with torch.no_grad():
        before, _ = TM.moe_apply_ep(layer, x, mesh)
        layer.w_up.mul_(1.5)                       # as AdamW's p.sub_
        c0 = TM.slice_copies()
        after, _ = TM.moe_apply_ep(layer, x, mesh)
        assert TM.slice_copies() - c0 == TP        # the w_up slices alone
    with torch.enable_grad():
        want, _ = TM.moe_apply_ep(layer, x, mesh)
    assert not torch.equal(after, before)
    assert torch.equal(after, want.detach())
    # a reassigned parameter (convert.py's assign) is seen too
    layer.w_down = torch.nn.Parameter(layer.w_down.detach() * 0.5)
    with torch.no_grad():
        again, _ = TM.moe_apply_ep(layer, x, mesh)
    with torch.enable_grad():
        want, _ = TM.moe_apply_ep(layer, x, mesh)
    assert torch.equal(again, want.detach())


def test_grad_mode_holds_nothing_and_grads_match(other_device):
    """Gradients through per-call copies equal the single-device ones
    (tests/test_torch_ep.py's check, with every slice copied)."""
    base = get_config("qwen2_moe_a2_7b").reduced()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, router="topk",
        capacity_factor=base.moe.n_experts / base.moe.top_k))
    hp = TrainHParams(aux_loss_weight=0.01)
    gen = torch.Generator().manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16),
                                     generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (4, 16),
                                     generator=gen)}
    plain = Transformer(cfg, 0, device="cpu")
    ep = copy.deepcopy(plain)
    grads_of(plain, batch, hp)
    grads_of(ep, batch, hp, _mesh(shape=(1, TP)))
    assert all(blk.moe._held == {} for blk in ep.layers)
    for (name, p0), p1 in zip(plain.named_parameters(), ep.parameters()):
        assert p1.grad is not None, name
        scale = max(float(p0.grad.abs().max()), 1.0)
        torch.testing.assert_close(p1.grad, p0.grad, rtol=1e-5,
                                   atol=1e-5 * scale)
