"""Expert parallelism of the port (``models.moe.moe_apply_ep``) against the
reference's single-device ``moe_apply``, in process, over a (data=2,
model=4) mesh of ``"cpu"`` positions; and the reduced qwen2_moe
``Transformer`` with and without a mesh.

Top-k routing is per token, so the expert-parallel layer computes the
single-device layer's function when neither drops an assignment (the
shapes of ``tests/test_moe_ep.py``: e=8, d=32, ff=16, k=2, x (4, 64, 32),
capacity factor 8; output within 5e-5 * max(scale, 1), aux within 0.3 as
that test asks: EP averages per-shard switch losses). The Sinkhorn router
balances over the tokens it sees, so the EP layer's shard i equals the
reference layer run on shard i's tokens alone (1e-5)."""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models.moe import init_moe, moe_apply
from repro_torch.configs.base import MoESpec, get_config
from repro_torch.models import moe as TM
from repro_torch.models.model import (TrainHParams, grads_of,
                                      make_serve_step, make_train_step)
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adamw
from repro_torch.runtime import sharding as TS

E, D, FF, K = 8, 32, 16, 2
CF = 8.0
EP_TOL = 5e-5
AUX_TOL = 0.3
SHARD_TOL = 1e-5
MODEL_TOL = 1e-5


def _mesh(shape=(2, 4)):
    return TS.make_mesh(shape, ("data", "model"), ["cpu"])


def _layer(router: str):
    """The reference's init_moe(PRNGKey(0), tp=4) weights, and the port's
    layer holding them."""
    p = init_moe(jax.random.PRNGKey(0), D, FF, E, 1, K, tp=4)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 64, D)) * 0.5
    spec = MoESpec(n_experts=E, n_shared=1, top_k=K, d_ff=FF, router=router,
                   capacity_factor=CF)
    layer = TM.MoE(D, spec, None, tp=4, device="meta")
    w = jax.tree.map(np.asarray, p)
    sd = {"router": w["router"].T, "w_gate": w["w_gate"],
          "w_up": w["w_up"], "w_down": w["w_down"],
          **{f"shared.{k}": v.T for k, v in w["shared"].items()}}
    layer.load_state_dict({k: torch.tensor(np.array(v))
                           for k, v in sd.items()}, assign=True)
    return p, x, layer


def test_ep_matches_reference_moe_apply():
    p, x, layer = _layer("topk")
    ref, aux_ref = moe_apply(p, x, K, "topk", capacity_factor=CF)
    before = TS.collective_counts()["psum"]
    with torch.no_grad():
        out, aux = TM.moe_apply_ep(layer, torch.tensor(np.array(x)), _mesh())
    assert TS.collective_counts()["psum"] - before == 1
    ref = np.asarray(ref)
    err = float(np.abs(out.numpy() - ref).max())
    scale = float(np.abs(ref).max())
    assert err < EP_TOL * max(scale, 1.0), (err, scale)
    assert abs(float(aux) - float(aux_ref)) < AUX_TOL


def test_ep_sinkhorn_shard_equals_reference_on_its_tokens():
    p, x, layer = _layer("sinkhorn")
    with torch.no_grad():
        out, _ = TM.moe_apply_ep(layer, torch.tensor(np.array(x)), _mesh())
    for i in range(2):          # data shard i holds batch rows 2i, 2i + 1
        want, _ = moe_apply(p, x[2 * i:2 * i + 2], K, "sinkhorn",
                            capacity_factor=CF, router_iters=6, n_real=E)
        np.testing.assert_allclose(out[2 * i:2 * i + 2].numpy(),
                                   np.asarray(want), rtol=SHARD_TOL,
                                   atol=SHARD_TOL)


def test_ep_psum_payload_and_meta_positions():
    """One psum a layer, its payload every position's (n_loc, d) operand;
    on 512 meta positions the layer keeps its shapes."""
    _, x, layer = _layer("topk")
    mesh = _mesh()
    b0 = TS.collective_bytes()["psum"]
    with torch.no_grad():
        TM.moe_apply_ep(layer, torch.tensor(np.array(x)), mesh)
    n_loc = 4 * 64 // 2
    assert TS.collective_bytes()["psum"] - b0 == mesh.size * n_loc * D * 4
    meta = TS.make_mesh((2, 64, 4), ("pod", "data", "model"), ["meta"])
    big = TM.MoE(D, layer.spec, None, tp=4, device="meta")
    c0 = TS.collective_counts()["psum"]
    out, aux = TM.moe_apply_ep(big, torch.zeros((128, 2, D), device="meta"),
                               meta)
    assert out.shape == (128, 2, D) and out.device.type == "meta"
    assert aux.shape == () and TS.collective_counts()["psum"] - c0 == 1
    with pytest.raises(ValueError, match="data shards"):
        TM.moe_apply_ep(big, torch.zeros((3, 1, D), device="meta"), meta)


def _qwen_topk():
    """The reduced qwen2_moe with the top-k router and a capacity factor
    (n_experts / top_k) that drops nothing, globally or per data shard."""
    cfg = get_config("qwen2_moe_a2_7b").reduced()
    moe = dataclasses.replace(cfg.moe, router="topk",
                              capacity_factor=cfg.moe.n_experts
                              / cfg.moe.top_k)
    return dataclasses.replace(cfg, moe=moe)


def _close(got, want, tol=MODEL_TOL):
    scale = max(float(want.abs().max()), 1.0)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * scale)


def test_transformer_forward_and_decode_with_mesh():
    cfg = _qwen_topk()
    model = Transformer(cfg, 0, device="cpu")
    mesh = _mesh()
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen)
    c0 = TS.collective_counts()["psum"]
    with torch.no_grad():
        h0, a0 = model(tokens)
        h1, a1 = model(tokens, mesh=mesh)
    assert TS.collective_counts()["psum"] - c0 == cfg.num_layers
    _close(h1, h0)
    plain, ep = make_serve_step(model), make_serve_step(model, mesh)
    c_plain, c_ep = model.init_cache(4, 8), model.init_cache(4, 8)
    with torch.no_grad():
        for t in range(8):
            _, l0, c_plain = plain(c_plain, tokens[:, t:t + 1])
            _, l1, c_ep = ep(c_ep, tokens[:, t:t + 1])
            _close(l1, l0)


@pytest.mark.parametrize("shape,aux_weight", [((1, 4), 0.01), ((2, 4), 0.0)])
def test_train_step_grads_with_mesh(shape, aux_weight):
    """Gradients through the host-driven psum equal the single-device
    ones. One data shard: the whole loss (aux equal too). Two data
    shards: the EP aux is the mean of per-shard switch losses, not the
    global one (the reference's semantics), so the comparison takes the
    cross-entropy alone (aux_loss_weight 0)."""
    cfg = _qwen_topk()
    mesh = _mesh(shape)
    hp = TrainHParams(aux_loss_weight=aux_weight)
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen)
    batch = {"tokens": tokens, "labels": labels}
    base = Transformer(cfg, 0, device="cpu")
    ep = copy.deepcopy(base)
    l0 = grads_of(base, batch, hp)
    l1 = grads_of(ep, batch, hp, mesh)
    for a, b in zip(l1 if shape[0] == 1 else l1[:2], l0):   # loss, ce(, aux)
        _close(a, b)
    for (name, p0), p1 in zip(base.named_parameters(), ep.parameters()):
        assert p1.grad is not None, name
        _close(p1.grad, p0.grad)
    # make_train_step takes the mesh the same way
    m0 = make_train_step(base, hp)(adamw.init(dict(base.named_parameters())),
                                   batch)
    m1 = make_train_step(ep, hp, mesh)(adamw.init(dict(ep.named_parameters())),
                                       batch)
    for k in ("loss", "ce", "grad_norm"):
        _close(m1[k], m0[k])
