"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP.
[arXiv:2402.16819; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="nemotron_4_340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8, head_dim=192,
    d_ff=73728, vocab_size=256000, mlp="squared_relu", norm="layernorm",
))
