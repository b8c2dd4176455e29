"""The port's LM against the reference for the reduced config of every
architecture (the ten of ``ARCH_IDS``, all six families), with the
reference's weights carried over by ``repro_torch.models.convert``:
``forward`` (hidden states and the MoE aux loss) and 8 greedy
``decode_step``s (equal tokens, logits) at rtol = atol = 1e-4. The
reference initializes qkv biases to zero, so the biases get random values
on both sides (qwen2_5_14b has ``qkv_bias``)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS, get_config
from repro.models import transformer as T
from repro_torch.configs.base import get_config as port_config
from repro_torch.models.convert import from_reference
from repro_torch.models.model import make_prefill, make_serve_step

TOL = dict(rtol=1e-4, atol=1e-4)
B, STEPS = 2, 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tensors are tiny: torch's intra-op threads only contend with
    the other test workers' (two 8-thread processes on 8 cores ran a
    dense_stabilized solve ~50x slower than one thread each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carried(arch: str, tp: int = 1, seed: int = 0):
    """(reference cfg, reference params, port model) with the same weights;
    random qkv biases where the config has them."""
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, jax.random.PRNGKey(seed), tp=tp)
    params = jax.tree.map(np.asarray, params)
    if cfg.qkv_bias:
        rng = np.random.default_rng(seed)
        attn = params["layers"]["attn"]
        for b in ("bq", "bk", "bv"):
            attn[b] = rng.standard_normal(attn[b].shape).astype(np.float32)
    model = from_reference(port_config(arch).reduced(), params, tp=tp,
                           device="cpu")
    return cfg, jax.tree.map(jnp.asarray, params), model


def test_ten_archs():
    assert len(ARCH_IDS) == 10
    assert {get_config(a).family for a in ARCH_IDS} == {
        "dense", "moe", "ssm", "hybrid", "vlm", "audio"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_and_decode_match_reference(arch):
    cfg, params, model = carried(arch)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, 16))
    want, want_aux = T.forward(cfg, params, jnp.asarray(tokens), remat=False)
    with torch.inference_mode():
        got, aux = model(torch.as_tensor(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)

    cache = T.init_cache(cfg, B, max_len=STEPS)
    tc = model.init_cache(B, STEPS)
    step = make_serve_step(model)
    tok = jnp.ones((B, 1), jnp.int32)
    ttok = torch.ones((B, 1), dtype=torch.long)
    ref_step = jax.jit(functools.partial(T.decode_step, cfg))
    for _ in range(STEPS):
        logits, cache = ref_step(params, cache, tok)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        with torch.inference_mode():
            ttok, tlogits, tc = step(tc, ttok)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(tok))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits), **TOL)
    assert tc["pos"] == int(cache["pos"]) == STEPS


@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen2_moe_a2_7b"])
def test_tp_padding_matches_reference(arch):
    """tp=3: ``tp_heads`` pads 4 query heads to 6 (kv 2 -> MHA 6), experts
    4 -> 6, vocab 512 -> 513; the padded model computes what the
    reference's does."""
    cfg, params, model = carried(arch, tp=3)
    assert (model.n_q, model.n_kv) == cfg.tp_heads(3) == (6, 6)
    assert model.embed.shape[0] == T.padded_vocab(cfg, 3) == 513
    if cfg.moe:
        assert model.layers[0].moe.n_experts == 6
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 8))
    want, _ = T.forward(cfg, params, jnp.asarray(tokens), tp=3, remat=False)
    with torch.inference_mode():
        got, _ = model(torch.as_tensor(tokens))
        logits = make_prefill(model)(torch.as_tensor(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_logits = np.asarray(want[:, -1] @ T.lm_head_matrix(cfg, params))
    assert logits.shape == (B, 513)
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
