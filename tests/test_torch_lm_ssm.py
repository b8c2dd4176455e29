"""The port's SSM (rwkv6) and hybrid (zamba2) families against the
reference at reduced size, with the reference's weights carried over by
``repro_torch.models.convert`` (every leaf moved off its init value, so a
leaf carried to the wrong place shows): the time-mix and Mamba2 layers'
chunked forwards and decode steps, the chunked forms against the port's
step oracles, rwkv6's head padding, prefill = decode, every cache state
after 8 greedy decode steps, the shared block's single copy, the
full-width parameter counts and the ``serve --arch`` CLI. rtol = atol =
1e-4 (the attention archs' tolerance) unless said."""
import functools
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

from repro.configs.base import get_config as ref_config
from repro.models import mamba2 as RM2
from repro.models import rwkv6 as RR6
from repro.models import transformer as T
from repro_torch.configs.base import get_config
from repro_torch.models import mamba2 as M2
from repro_torch.models import rwkv6 as R6
from repro_torch.models.convert import from_reference
from repro_torch.models.model import make_prefill, make_serve_step
from repro_torch.models.transformer import Transformer

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["rwkv6_3b", "zamba2_7b"]
TOL = dict(rtol=1e-4, atol=1e-4)
B, T_LEN, STEPS = 2, 32, 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tensors are tiny: torch's intra-op threads only contend with
    the other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def carried(arch: str, tp: int = 1):
    """(reference cfg, reference params as jax arrays, port model) with the
    same weights: the reference's init with N(0, 0.05^2) added to every
    leaf, so that mu, w0, u, a_log, the biases and the norm scales differ
    from their constant inits."""
    cfg = ref_config(arch).reduced()
    params = jax.tree.map(np.asarray, jax.jit(
        T.init_params, static_argnums=(0, 2))(cfg, jax.random.PRNGKey(0), tp))
    rng = np.random.default_rng(tp)
    params = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(
        a.shape)).astype(np.float32), params)
    model = from_reference(get_config(arch).reduced(), params, tp=tp,
                           device="cpu")
    return cfg, jax.tree.map(jnp.asarray, params), model


def _first(tree, lead: int):
    """Layer 0 of leaves stacked on ``lead`` leading dims."""
    return jax.tree.map(lambda a: a[(0,) * lead], tree)


def _inputs(d: int, t: int = T_LEN, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, t, d)).astype(np.float32)


def _close(got: torch.Tensor, want, **tol) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


# ------------------------------------------------------------- the layers
def test_rwkv6_train_matches_reference():
    cfg, params, model = carried("rwkv6_3b")
    s = cfg.ssm
    x = _inputs(cfg.d_model)
    want = RR6.rwkv6_train(_first(params["layers"]["tmix"], 1),
                           jnp.asarray(x), s.head_dim, s.chunk)
    with torch.inference_mode():
        got = R6.rwkv6_train(model.layers[0].tmix, torch.as_tensor(x),
                             s.head_dim, s.chunk)
    _close(got, want)


def test_rwkv6_decode_matches_reference():
    """One step from random shift and wkv states: out, shift, wkv."""
    cfg, params, model = carried("rwkv6_3b")
    hd, d = cfg.ssm.head_dim, cfg.d_model
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 1, d)).astype(np.float32)
    shift = rng.standard_normal((B, 1, d)).astype(np.float32)
    wkv = 0.5 * rng.standard_normal((B, d // hd, hd, hd)).astype(np.float32)
    want = RR6.rwkv6_decode(_first(params["layers"]["tmix"], 1),
                            jnp.asarray(x), jnp.asarray(shift),
                            jnp.asarray(wkv), hd)
    with torch.inference_mode():
        got = R6.rwkv6_decode(model.layers[0].tmix, torch.as_tensor(x),
                              torch.as_tensor(shift), torch.as_tensor(wkv),
                              hd)
    for g, w in zip(got, want):
        _close(g, w)


def test_mamba2_train_matches_reference():
    cfg, params, model = carried("zamba2_7b")
    s = cfg.ssm
    x = _inputs(cfg.d_model)
    want = RM2.mamba2_train(_first(params["layers"]["mamba"], 2),
                            jnp.asarray(x), s.d_state, s.head_dim, s.chunk)
    with torch.inference_mode():
        got = M2.mamba2_train(model.layers[0].mamba, torch.as_tensor(x),
                              s.d_state, s.head_dim, s.chunk)
    _close(got, want)


def test_mamba2_decode_matches_reference():
    """One step from random conv and SSM states: y, conv state, SSM
    state."""
    cfg, params, model = carried("zamba2_7b")
    s, d = cfg.ssm, cfg.d_model
    d_in = s.expand * d
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 1, d)).astype(np.float32)
    conv = rng.standard_normal(
        (B, s.conv_width - 1, d_in + 2 * s.d_state)).astype(np.float32)
    ssm = 0.5 * rng.standard_normal(
        (B, d_in // s.head_dim, s.d_state, s.head_dim)).astype(np.float32)
    want = RM2.mamba2_decode(_first(params["layers"]["mamba"], 2),
                             jnp.asarray(x), jnp.asarray(conv),
                             jnp.asarray(ssm), s.d_state, s.head_dim)
    with torch.inference_mode():
        got = M2.mamba2_decode(model.layers[0].mamba, torch.as_tensor(x),
                               torch.as_tensor(conv), torch.as_tensor(ssm),
                               s.d_state, s.head_dim)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_matches_step_oracle(arch):
    """The chunked forward against the port's own step-by-step oracle at
    T = 2 chunks, so the state carries across a chunk boundary."""
    cfg, _, model = carried(arch)
    s = cfg.ssm
    x = torch.as_tensor(_inputs(cfg.d_model, 2 * s.chunk))
    with torch.inference_mode():
        if arch == "rwkv6_3b":
            tm = model.layers[0].tmix
            got = R6.rwkv6_train(tm, x, s.head_dim, s.chunk)
            want = R6.rwkv6_ref(tm, x, s.head_dim)
        else:
            mb = model.layers[0].mamba
            got = M2.mamba2_train(mb, x, s.d_state, s.head_dim, s.chunk)
            want = M2.mamba2_ref(mb, x, s.d_state, s.head_dim)
    _close(got, want.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_must_divide_sequence(arch):
    cfg, _, model = carried(arch)
    s = cfg.ssm
    x = torch.as_tensor(_inputs(cfg.d_model, s.chunk + s.chunk // 2))
    with pytest.raises(ValueError, match=f"T={x.shape[1]} .*{s.chunk}"):
        if arch == "rwkv6_3b":
            R6.rwkv6_train(model.layers[0].tmix, x, s.head_dim, s.chunk)
        else:
            M2.mamba2_train(model.layers[0].mamba, x, s.d_state, s.head_dim,
                            s.chunk)


def test_rwkv6_head_padding_at_tp3():
    """tp=3 pads rwkv6's 8 heads of 8 to 9: d_attn = 72 != d_model = 64, so
    ``wo`` and ``ln_scale`` follow d_attn; the padded model computes what
    the reference's does."""
    cfg, params, model = carried("rwkv6_3b", tp=3)
    tm = model.layers[0].tmix
    assert tm.wo.shape == (64, 72) and tm.ln_scale.shape == (72,)
    assert tm.u.shape == (9, 8) and tm.wr.shape == (72, 64)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, 16))
    want, _ = T.forward(cfg, params, jnp.asarray(tokens), tp=3, remat=False)
    with torch.inference_mode():
        got, _ = model(torch.as_tensor(tokens))
        cache = model.init_cache(B, 4)
    _close(got, want)
    ref_cache = T.init_cache(cfg, B, 4, tp=3)
    assert tuple(cache["wkv"].shape) == ref_cache["wkv"].shape \
        == (2, B, 9, 8, 8)


# ---------------------------------------------------------- the LM path
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_decode(arch):
    """Decoding token by token reproduces the prefill logits at the
    reference's 2e-3 (its ``test_prefill_matches_decode``), at T = 32: two
    chunks of 16, so the carry between chunks is on the path."""
    cfg = get_config(arch).reduced()
    model = Transformer(cfg, 0, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, T_LEN)))
    with torch.inference_mode():
        hidden, _ = model(tokens)
        full = torch.nn.functional.linear(
            hidden, model.lm_head_matrix())[..., :cfg.vocab_size]
        cache = model.init_cache(B, T_LEN)
        dec = torch.stack([model.decode_step(cache, tokens[:, t:t + 1])[0]
                           for t in range(T_LEN)], 1)
        last = make_prefill(model)(tokens)[:, :cfg.vocab_size]
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_states_match_reference(arch):
    """After 8 greedy decode steps from token 1 every state of the port's
    cache equals the reference's: shift and wkv (ssm); conv, ssm,
    conv_rem, ssm_rem, k and v (hybrid, one k and v per application of the
    shared block)."""
    cfg, params, model = carried(arch)
    cache = T.init_cache(cfg, B, max_len=STEPS)
    tc = model.init_cache(B, STEPS)
    assert set(tc) == set(cache)
    step = make_serve_step(model)
    ref_step = jax.jit(functools.partial(T.decode_step, cfg))
    tok = jnp.ones((B, 1), jnp.int32)
    ttok = torch.ones((B, 1), dtype=torch.long)
    for _ in range(STEPS):
        logits, cache = ref_step(params, cache, tok)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        with torch.inference_mode():
            ttok, tlogits, tc = step(tc, ttok)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(tok))
        _close(tlogits, logits)
    assert tc["pos"] == int(cache["pos"]) == STEPS
    for key in sorted(set(tc) - {"pos"}):
        assert tuple(tc[key].shape) == cache[key].shape, key
        _close(tc[key], cache[key])
    # the channel-mix's shift slot is written (and never read): R11
    if arch == "rwkv6_3b":
        assert float(tc["shift"][:, 1].abs().max()) > 0


def test_shared_block_counted_once():
    """The hybrid holds ONE shared block: its parameters appear once in
    ``parameters()`` and ``state_dict()``, and the port's count equals the
    reference's leaves'."""
    cfg, params, model = carried("zamba2_7b")
    shared = {id(p) for p in model.shared_block.parameters()}
    listed = [p for p in model.parameters() if id(p) in shared]
    assert len(listed) == len(shared) > 0
    sd = model.state_dict()
    n_shared_leaves = len(jax.tree.leaves(params["shared_block"]))
    assert sum(k.startswith("shared_block.") for k in sd) == n_shared_leaves
    assert not any(".attn." in k for k in sd
                   if not k.startswith("shared_block."))
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(params))
    assert model.n_groups == 2 and len(model.layers) == cfg.num_layers == 5


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_count_matches_reference(arch):
    """At full width (on the meta device: no memory) the port's parameter
    count equals the reference's (``jax.eval_shape`` of its init)."""
    cfg = ref_config(arch)
    shapes = jax.eval_shape(lambda k: T.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    model = Transformer(get_config(arch), device="meta")
    assert sum(p.numel() for p in model.parameters()) == want
    assert want == {"rwkv6_3b": 2_863_434_240,
                    "zamba2_7b": 6_751_130_832}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_arch_cli_on_cpu(arch):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
           "--reduced", "--device", "cpu", "--steps", "4"]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=180, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["arch"] == arch and rec["device"] == "cpu"
    assert rec["batch"] == 4 and rec["steps"] == 4
    for key in ("ms_per_token_p50", "ms_per_token_p99", "tokens_per_s"):
        assert np.isfinite(rec[key]) and rec[key] > 0
