"""rwkv6-3b [ssm] — Finch: attention-free, data-dependent decay.

Sub-quadratic: runs the long_500k cell. [arXiv:2404.05892; hf]
"""
from .base import ArchConfig, SSMSpec, register

CONFIG = register(ArchConfig(
    name="rwkv6_3b", family="ssm",
    num_layers=32, d_model=2560, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=8960, vocab_size=65536, mlp="squared_relu", norm="rmsnorm",
    rope_theta=None,
    ssm=SSMSpec(kind="rwkv6", head_dim=64, decay_lora=64),
))
