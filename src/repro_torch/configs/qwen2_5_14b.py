"""qwen2.5-14b [dense] — GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2_5_14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=13824, vocab_size=152064, mlp="swiglu", norm="rmsnorm",
    qkv_bias=True, rope_theta=1000000.0,
))
