"""Gradient compression with error feedback (port of
``repro.runtime.compression``).

int8 block quantization: each gradient tensor is quantized to int8 with
per-block fp32 scales (absmax / 127 over blocks of the flattened tensor),
so a cross-node all-reduce could carry 4x fewer bytes; the quantization
residual is kept and added into the next step's gradient (error
feedback, Karimireddy et al. 2019). ``launch/train.py`` takes
``--grad-compression int8`` as the reference's single-host driver does:
it creates the residual and applies nothing, since one process has no
cross-node reduction to compress.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def quantize_int8(x: torch.Tensor, block: int = 256):
    """x (...) -> (q int8 (nblocks, block), scales fp32 (nblocks, 1)):
    per-block absmax scaling of the flattened tensor, zero-padded to a
    block multiple; round half to even, as ``jnp.round``."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    blocks = F.pad(flat, (0, -(-n // block) * block - n)).reshape(-1, block)
    scale = blocks.abs().amax(1, keepdim=True) / 127.0
    scale = scale.clamp(min=1e-12)
    q = torch.round(blocks / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape).to(dtype)


def compress_grads_with_feedback(grads: dict, residual: dict,
                                 block: int = 256) -> tuple[dict, dict]:
    """(grads + residual) -> (its quantize-dequantize round trip, the new
    residual), per key. The returned grads are what the optimizer would
    consume, identical on every node; the residual is the local
    quantization error, added into the next step's grads."""
    new_grads, new_res = {}, {}
    for k, g in grads.items():
        x = g + residual[k]
        q, s = quantize_int8(x, block)
        deq = dequantize_int8(q, s, g.shape, g.dtype)
        new_grads[k], new_res[k] = deq, x - deq
    return new_grads, new_res


def zero_residual(params: dict) -> dict:
    return {k: torch.zeros_like(p) for k, p in params.items()}
