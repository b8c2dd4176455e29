"""Serve-side model bundle of the port (port of ``make_serve_step`` and
``make_prefill`` of ``repro.models.model``): the callables the LM decode
server runs. Call them under ``torch.inference_mode()``."""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from .transformer import Transformer


def make_serve_step(model: Transformer) -> Callable:
    """(cache, tokens (B, 1)) -> (next_tokens (B, 1), logits (B, V), cache):
    one greedy decode step; the cache advances in place."""

    def serve_step(cache: dict, tokens: torch.Tensor):
        logits, cache = model.decode_step(cache, tokens)
        nxt = logits.argmax(-1).to(tokens.dtype)[:, None]
        return nxt, logits, cache

    return serve_step


def make_prefill(model: Transformer, block_k: int = 512) -> Callable:
    """tokens (B, T) -> logits (B, Vp) of the last position, fp32: the
    inference forward (no loss, no grads)."""

    def prefill(tokens: torch.Tensor) -> torch.Tensor:
        hidden, _ = model(tokens, block_k)
        return F.linear(hidden[:, -1], model.lm_head_matrix()).float()

    return prefill
