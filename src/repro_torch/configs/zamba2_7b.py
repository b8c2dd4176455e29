"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block.

81 Mamba2 layers; ONE weight-shared (attn + MLP) block applied every 6th
layer (13 applications + 3 trailing mamba layers). Sub-quadratic: runs the
long_500k cell. [arXiv:2411.15242; unverified]
"""
from .base import ArchConfig, SSMSpec, register

CONFIG = register(ArchConfig(
    name="zamba2_7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000, mlp="swiglu", norm="rmsnorm",
    ssm=SSMSpec(kind="mamba2", d_state=64, head_dim=64, expand=2),
    attn_every=6,
    notes="shared attn block weights reused at every application; "
          "each application has its own KV cache",
))
