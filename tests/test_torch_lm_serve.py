"""The port's LM serve path on the host: mirrors of the reference's
``test_prefill_matches_decode`` and ``test_param_counts_match_config_estimate``
(``tests/test_arch_smoke.py``) and the ``serve --arch`` CLI."""
import dataclasses
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
from repro.models import transformer as T
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.models.convert import from_reference
from repro_torch.models.model import make_prefill
from repro_torch.models.transformer import Transformer

ROOT = Path(__file__).resolve().parents[1]
B = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tensors are tiny: torch's intra-op threads only contend with
    the other test workers' (two 8-thread processes on 8 cores ran a
    dense_stabilized solve ~50x slower than one thread each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prefill_and_decode(model, tokens):
    """Logits of every position from one forward and from decoding the
    tokens one at a time."""
    with torch.inference_mode():
        hidden, _ = model(tokens)
        full = torch.nn.functional.linear(hidden, model.lm_head_matrix())
        cache = model.init_cache(B, tokens.shape[1])
        dec = torch.stack([model.decode_step(cache, tokens[:, t:t + 1])[0]
                           for t in range(tokens.shape[1])], dim=1)
    return full[..., :model.cfg.vocab_size].numpy(), dec.numpy()


@pytest.mark.parametrize("arch,router", [
    ("granite_3_2b", None), ("musicgen_large", None),
    ("qwen2_5_14b", None), ("qwen2_moe_a2_7b", "topk")])
def test_prefill_matches_decode(arch, router):
    """Decoding token by token reproduces the prefill logits (the
    serve-path invariant) at the reference's 2e-3. The MoE runs the
    per-token softmax router with a slot for every token (capacity factor
    E / k), so neither pass drops an assignment: routing and capacity then
    do not depend on the batch (R9)."""
    cfg = get_config(arch).reduced()
    if router:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, router=router,
            capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    model = Transformer(cfg, 0, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, 8)))
    full, dec = _prefill_and_decode(model, tokens)
    np.testing.assert_allclose(dec, full, rtol=2e-3, atol=2e-3)
    with torch.inference_mode():
        last = make_prefill(model)(tokens)[:, :cfg.vocab_size]
    np.testing.assert_allclose(last.numpy(), full[:, -1], rtol=1e-5,
                               atol=1e-5)


def test_sinkhorn_moe_prefill_differs_from_decode_as_reference():
    """The Sinkhorn router balances over the tokens routed together, so an
    MoE layer's output depends on its batch: a prefill of 8 positions and
    8 one-token decodes route differently, in the reference (R9) and in the
    port alike. Both packages' gaps are the same gap."""
    cfg = ref_config("qwen2_moe_a2_7b").reduced()
    params = T.init_params(cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 8))
    hidden, _ = T.forward(cfg, params, jnp.asarray(tokens), remat=False)
    ref_full = np.asarray(hidden @ T.lm_head_matrix(cfg, params))
    cache = T.init_cache(cfg, B, max_len=8)
    ref_dec = []
    for t in range(8):
        logits, cache = T.decode_step(cfg, params, cache,
                                      jnp.asarray(tokens[:, t:t + 1]))
        ref_dec.append(np.asarray(logits))
    ref_gap = np.abs(np.stack(ref_dec, 1) - ref_full).max()
    model = from_reference(get_config("qwen2_moe_a2_7b").reduced(),
                           jax.tree.map(np.asarray, params), device="cpu")
    full, dec = _prefill_and_decode(model, torch.as_tensor(tokens))
    gap = np.abs(dec - full).max()
    assert ref_gap > 0.1 and gap > 0.1
    assert gap == pytest.approx(ref_gap, rel=1e-3)


def test_param_counts_match_config_estimate():
    """Every arch's reduced model against ``n_params()`` within 25%, as the
    reference's test (the hybrid's shared block counted once)."""
    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced()
        model = Transformer(cfg, 0, device="cpu")
        actual = sum(p.numel() for p in model.parameters())
        est = cfg.n_params()
        assert abs(actual - est) / actual < 0.25, (arch, actual, est)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_serve_arch_cli_on_cpu():
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "qwen2_moe_a2_7b", "--reduced", "--device", "cpu", "--steps", "4"]
    out = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                         timeout=180, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["arch"] == "qwen2_moe_a2_7b" and rec["device"] == "cpu"
    assert rec["batch"] == 4 and rec["steps"] == 4
    for key in ("ms_per_token_p50", "ms_per_token_p99", "tokens_per_s"):
        assert np.isfinite(rec[key]) and rec[key] > 0


def test_serve_arch_cli_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "granite_3_2b", "--reduced", "--steps", "2"]
    out = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                         timeout=180, cwd=ROOT)
    assert out.returncode != 0
    assert "RuntimeError" in out.stderr and "CUDA" in out.stderr
