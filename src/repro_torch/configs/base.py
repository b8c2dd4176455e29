"""Architecture config system (the port's copy of ``repro.configs.base``,
the same dataclasses and values; it imports nothing of JAX).

Every assigned architecture is an ``ArchConfig`` in its own module
(``repro_torch.configs.<id>``) selectable via ``--arch <id>`` in the
serve launcher. ``reduced()`` yields the CPU-smoke-test variant of the
same family.

TP head adjustment: the production mesh fixes the tensor-parallel degree
at 16, so head counts are adapted at build time:
  - query heads padded up to a multiple of tp (zero-capacity heads;
    function-preserving for checkpoint import via a head permutation);
  - kv heads: kept if divisible by tp; replicated tp/kv per kv head if tp %
    kv == 0 (exact GQA pairing preserved); else converted to MHA (the
    vLLM/Megatron fallback).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    n_shared: int          # fused into one shared expert of n_shared*d_ff
    top_k: int
    d_ff: int              # per-expert hidden dim
    router: str = "sinkhorn"   # paper integration default; "topk" baseline
    capacity_factor: float = 1.25
    router_iters: int = 6


@dataclass(frozen=True)
class SSMSpec:
    kind: str              # "mamba2" | "rwkv6"
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    decay_lora: int = 64
    chunk: int = 128


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str            # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    mlp: str = "swiglu"
    norm: str = "rmsnorm"
    qkv_bias: bool = False
    rope_theta: float | None = 10000.0
    moe: MoESpec | None = None
    ssm: SSMSpec | None = None
    attn_every: int = 0    # hybrid: shared attn+mlp block every k ssm layers
    tie_embeddings: bool = False
    notes: str = ""

    # ---- derived -----------------------------------------------------
    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def tp_heads(self, tp: int) -> tuple[int, int]:
        """(n_q_eff, n_kv_eff) after TP padding/replication (see module doc)."""
        if self.num_heads == 0:
            return 0, 0
        n_q = -(-self.num_heads // tp) * tp
        kv = self.num_kv_heads
        if kv % tp == 0:
            n_kv = kv
        elif tp % kv == 0:
            n_kv = tp
        else:
            n_kv = n_q                       # MHA fallback (e.g. phi3 kv=10)
        if n_q % n_kv != 0:
            n_kv = n_q
        return n_q, n_kv

    def n_params(self) -> int:
        """Approximate true (unpadded) parameter count."""
        d, nl, v = self.d_model, self.num_layers, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        per = 0
        if self.ssm and self.ssm.kind == "mamba2":
            di = self.ssm.expand * d
            per += d * (2 * di + 2 * self.ssm.d_state + di // self.ssm.head_dim)
            per += di * d
        elif self.ssm and self.ssm.kind == "rwkv6":
            per += 5 * d * d + 2 * d * self.ssm.decay_lora
            per += 2 * d * self.d_ff        # channel mix
        if self.num_heads:
            hd = self.head_dim
            attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
                + self.num_heads * hd * d
            if self.attn_every:             # hybrid: ONE shared block
                per_shared = attn + 3 * d * self.d_ff
                return emb + nl * per + per_shared
            per += attn
        if self.moe:
            per += d * self.moe.n_experts
            per += 3 * d * self.moe.d_ff * self.moe.n_experts
            per += 3 * d * self.moe.d_ff * self.moe.n_shared
        elif self.d_ff and not self.ssm:
            mult = 3 if self.mlp == "swiglu" else 2
            per += mult * d * self.d_ff
        return emb + nl * per

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top_k + shared)."""
        if not self.moe:
            return self.n_params()
        d, nl = self.d_model, self.num_layers
        total = self.n_params()
        all_experts = 3 * d * self.moe.d_ff * self.moe.n_experts * nl
        active = 3 * d * self.moe.d_ff * self.moe.top_k * nl
        return total - all_experts + active

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        changes: dict = dict(
            num_layers=2, d_model=64, vocab_size=512,
        )
        if self.num_heads:
            changes.update(num_heads=4, num_kv_heads=max(1, min(
                self.num_kv_heads, 2)), head_dim=16)
        if self.d_ff:
            changes.update(d_ff=128)
        if self.moe:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2,
                n_shared=min(self.moe.n_shared, 1), d_ff=64)
        if self.ssm:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=8, head_dim=8, decay_lora=8, chunk=16)
        if self.attn_every:
            changes.update(num_layers=5, attn_every=2)
        return dataclasses.replace(self, **changes)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> dict[str, ArchConfig]:
    if not _REGISTRY:
        load_all()
    return dict(_REGISTRY)


ARCH_IDS = [
    "chameleon_34b", "zamba2_7b", "qwen2_5_14b", "phi3_medium_14b",
    "nemotron_4_340b", "granite_3_2b", "qwen2_moe_a2_7b",
    "qwen3_moe_235b_a22b", "musicgen_large", "rwkv6_3b",
]


def load_all() -> None:
    import importlib
    for mod in ARCH_IDS:
        importlib.import_module(f"repro_torch.configs.{mod}")
