"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4.

Sinkhorn router (the paper's technique) is the default; --router topk for
the baseline. [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from .base import ArchConfig, MoESpec, register

CONFIG = register(ArchConfig(
    name="qwen2_moe_a2_7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    vocab_size=151936, mlp="swiglu", norm="rmsnorm",
    moe=MoESpec(n_experts=60, n_shared=4, top_k=4, d_ff=1408),
))
