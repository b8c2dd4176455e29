"""chameleon-34b [vlm] — early-fusion multimodal decoder over VQ image tokens.

Backbone only (assignment): the modality frontend is the VQ token stream
itself, so input_specs() supplies token ids. [arXiv:2405.09818; unverified]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chameleon_34b", family="vlm",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=65536, mlp="swiglu", norm="rmsnorm",
    notes="early-fusion VLM; VQ image tokens share the text vocab",
))
