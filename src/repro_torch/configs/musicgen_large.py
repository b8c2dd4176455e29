"""musicgen-large [audio] — decoder-only over EnCodec tokens.

Backbone only: input_specs() supplies precomputed EnCodec frame token ids
(the audio frontend stub per the assignment). [arXiv:2306.05284; hf]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen_large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048, mlp="gelu", norm="layernorm",
))
