"""phi3-medium-14b [dense] — RoPE SwiGLU GQA (kv=10 -> MHA fallback at
TP=16, see ArchConfig.tp_heads). [arXiv:2404.14219; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi3_medium_14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10, head_dim=128,
    d_ff=17920, vocab_size=100352, mlp="swiglu", norm="rmsnorm",
))
