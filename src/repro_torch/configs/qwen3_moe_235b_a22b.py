"""qwen3-moe-235b-a22b [moe] — 128 routed experts, top-8, no shared.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from .base import ArchConfig, MoESpec, register

CONFIG = register(ArchConfig(
    name="qwen3_moe_235b_a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    vocab_size=151936, mlp="swiglu", norm="rmsnorm",
    moe=MoESpec(n_experts=128, n_shared=0, top_k=8, d_ff=1536),
))
