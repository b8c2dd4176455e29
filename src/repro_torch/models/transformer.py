"""Decoder-only LM of the port: config -> model -> forward / decode (port of
``repro.models.transformer`` for the attention families).

    dense / vlm / audio  [attn + mlp] x L
    moe                  [attn + moe] x L (Sinkhorn or top-k router)

The layers are a plain ``nn.ModuleList`` walked in order; the reference
stacks them on a leading dim for one ``lax.scan`` (with remat), which
computes the same function. The reference's functions map onto
:class:`Transformer`: ``init_params`` is its constructor, ``forward`` its
``forward``, ``lm_head_matrix`` / ``init_cache`` / ``decode_step`` its
methods of those names. Families ``ssm`` (rwkv6) and ``hybrid`` (zamba2)
need ``mamba2.py`` and ``rwkv6.py``, which the port does not carry yet:
they raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from .layers import MLP, Attention, Norm, normal_param
from .moe import MoE

ATTN_FAMILIES = ("dense", "moe", "vlm", "audio")


def padded_vocab(cfg: ArchConfig, tp: int) -> int:
    """Megatron-style vocab padding: embeddings and logits shard over the
    model axis."""
    return -(-cfg.vocab_size // tp) * tp


def check_family(cfg: ArchConfig) -> None:
    if cfg.family in ("ssm", "hybrid"):
        mod = "rwkv6" if cfg.family == "ssm" else "mamba2"
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} needs the {mod} layers "
            f"(repro.models.{mod}), which the port does not carry yet; it "
            "runs families " + ", ".join(ATTN_FAMILIES))
    if cfg.family not in ATTN_FAMILIES:
        raise ValueError(cfg.family)


class Block(nn.Module):
    """Pre-norm [attention + (MLP | MoE)] block."""

    def __init__(self, cfg: ArchConfig, n_q: int, n_kv: int, generator,
                 tp: int, device, dtype):
        super().__init__()
        d = cfg.d_model
        self.norm1 = Norm(cfg.norm, d, device, dtype)
        self.norm2 = Norm(cfg.norm, d, device, dtype)
        self.attn = Attention(d, n_q, n_kv, cfg.head_dim, cfg.qkv_bias,
                              cfg.rope_theta, generator, device, dtype)
        if cfg.moe:
            self.moe = MoE(d, cfg.moe, generator, tp, device, dtype)
            self.mlp = None
        else:
            self.mlp = MLP(d, cfg.d_ff, cfg.mlp, generator, device, dtype)
            self.moe = None

    def _ffn(self, h: torch.Tensor):
        hn = self.norm2(h)
        if self.moe is not None:
            out, aux = self.moe(hn)
            return h + out, aux
        return h + self.mlp(hn), h.new_zeros(())

    def forward(self, h: torch.Tensor, block_k: int = 512):
        """The reference's ``_attn_mlp_block``: (h, aux)."""
        h = h + self.attn(self.norm1(h), block_k)
        return self._ffn(h)

    def decode(self, h: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
               pos: int) -> torch.Tensor:
        """The reference's ``_attn_block_decode``; ck and cv are written in
        place."""
        h = h + self.attn.decode(self.norm1(h), ck, cv, pos)
        return self._ffn(h)[0]


class Transformer(nn.Module):
    """The LM for ``cfg`` (families dense, moe, vlm, audio), its parameters
    created on ``device`` (``cuda`` by default; raises without one) from
    ``generator`` (a ``torch.Generator`` on that device, or an int seed).
    ``tp`` keeps the reference's shape rules: ``tp_heads`` head padding,
    expert and vocab padding."""

    def __init__(self, cfg: ArchConfig, generator=0, tp: int = 1,
                 device=None, dtype=torch.float32):
        super().__init__()
        check_family(cfg)
        device = (torch.device("meta") if str(device) == "meta"
                  else resolve_device(device))
        if isinstance(generator, int):
            generator = (torch.Generator(device=device).manual_seed(generator)
                         if device.type != "meta" else None)
        self.cfg, self.tp = cfg, tp
        d = cfg.d_model
        self.n_q, self.n_kv = cfg.tp_heads(tp)
        vp = padded_vocab(cfg, tp)
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.embed = normal_param((vp, d), 0.02, **kw)
        self.final_norm = Norm(cfg.norm, d, device, dtype)
        self.lm_head = (None if cfg.tie_embeddings
                        else normal_param((vp, d), d ** -0.5, **kw))
        self.layers = nn.ModuleList(
            Block(cfg, self.n_q, self.n_kv, generator, tp, device, dtype)
            for _ in range(cfg.num_layers))

    def lm_head_matrix(self) -> torch.Tensor:
        """(Vp, d), the ``nn.Linear`` layout (logits = ``F.linear(h, W)``):
        the embedding when tied, else the LM head."""
        return self.embed if self.lm_head is None else self.lm_head

    def forward(self, tokens: torch.Tensor, block_k: int = 512):
        """tokens (B, T) -> (hidden (B, T, d) after the final norm, aux
        load-balance loss summed over the layers)."""
        h = F.embedding(tokens, self.embed)
        bk = min(block_k, tokens.shape[1])
        aux = h.new_zeros(())
        for blk in self.layers:
            h, a = blk(h, bk)
            aux = aux + a
        return self.final_norm(h), aux

    def init_cache(self, batch: int, max_len: int) -> dict:
        """Zero-filled serve cache on the model's device: k and v (L, B,
        n_kv, max_len, hd) and ``pos`` (the next position, a host int)."""
        w = self.embed
        shp = (self.cfg.num_layers, batch, self.n_kv, max_len,
               self.cfg.head_dim)
        return {"pos": 0,
                "k": torch.zeros(shp, dtype=w.dtype, device=w.device),
                "v": torch.zeros(shp, dtype=w.dtype, device=w.device)}

    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """One-token decode. tokens (B, 1) -> (logits (B, V) fp32, cache).
        The cache's k and v are written in place and ``pos`` advances."""
        pos = cache["pos"]
        h = F.embedding(tokens, self.embed)
        for i, blk in enumerate(self.layers):
            h = blk.decode(h, cache["k"][i], cache["v"][i], pos)
        h = self.final_norm(h)
        logits = F.linear(h[:, 0], self.lm_head_matrix()).float()
        cache["pos"] = pos + 1
        return logits[:, :self.cfg.vocab_size], cache   # drop padded rows
