"""The depths at which ``chip_smoke.py`` runs the five archs it holds at
full width (``LM_WIDE``): the port's ``Transformer`` built on ``meta`` at
each depth holds exactly the reference config's ``n_params()`` in its
matrices (the norms and qkv biases, which ``n_params`` leaves out, are
counted apart), and the fp32 weights of a cut depth are the most that
stay at or under ~70 GB of the card's 80."""
import dataclasses
import sys
from pathlib import Path

import pytest

from repro.configs.base import get_config as ref_config
from repro_torch.configs.base import get_config
from repro_torch.models.transformer import Transformer

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

WEIGHT_BUDGET = 70e9          # bytes of fp32 weights on an 80 GB card


def _at(cfg, layers: int):
    return dataclasses.replace(cfg, num_layers=layers)


@pytest.mark.parametrize("arch,phase,layers", chip_smoke.LM_WIDE,
                         ids=[a for a, _, _ in chip_smoke.LM_WIDE])
def test_cut_depth_params_and_budget(arch, phase, layers):
    cfg = _at(get_config(arch), layers)
    model = Transformer(cfg, device="meta")
    mats = sum(p.numel() for p in model.parameters() if p.ndim >= 2)
    vecs = sum(p.numel() for p in model.parameters() if p.ndim < 2)
    assert mats == _at(ref_config(arch), layers).n_params()
    norm = cfg.d_model * (2 if cfg.norm == "layernorm" else 1)
    bias = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim \
        if cfg.qkv_bias else 0
    assert vecs == norm + layers * (2 * norm + bias)
    published = get_config(arch).num_layers
    per_layer = _at(cfg, 1).n_params() - _at(cfg, 0).n_params()
    assert 4 * cfg.n_params() <= WEIGHT_BUDGET
    if layers < published:
        assert 4 * (cfg.n_params() + per_layer) > WEIGHT_BUDGET
    else:
        assert layers == published
    assert phase.startswith("lm_full" if layers == published else "lm_wide")


def test_lm_small_covers_all_ten_archs():
    from repro_torch.configs.base import ARCH_IDS
    assert {a for a, _ in chip_smoke.LM_SMALL} == set(ARCH_IDS)
    assert {a for a, _, _ in chip_smoke.LM_WIDE} == {
        "qwen2_5_14b", "phi3_medium_14b", "chameleon_34b",
        "nemotron_4_340b", "qwen3_moe_235b_a22b"}
    assert get_config("qwen3_moe_235b_a22b").reduced().moe.n_shared == 0
    assert Transformer(get_config("qwen3_moe_235b_a22b").reduced(),
                       device="meta").layers[0].moe.shared is None
