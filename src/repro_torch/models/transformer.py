"""Decoder-only LM of the port: config -> model -> forward / decode (port of
``repro.models.transformer``).

    dense / vlm / audio  [attn + mlp] x L
    moe                  [attn + moe] x L (Sinkhorn or top-k router)
    ssm (rwkv6)          [time-mix + channel-mix] x L
    hybrid (zamba2)      groups of ``attn_every`` Mamba2 layers, each group
                         followed by ONE weight-shared [attn + mlp] block,
                         then the layers that fill no group

The layers are a plain ``nn.ModuleList`` walked in order; the reference
stacks them on a leading dim for one ``lax.scan`` (the hybrid on two,
groups x layers in a group), which computes the same function. The
hybrid's ``layers`` hold all of its Mamba2 layers, layer i = g *
attn_every + e of group g, the remainder last. ``forward(remat=True)``
keeps the reference's activation checkpointing (``jax.checkpoint``) with
``torch.utils.checkpoint``: the two-level sqrt(L) schedule of
``two_level_scan`` (each layer and each group of layers checkpointed),
and for the hybrid each Mamba2 layer and each group with its shared
block. The reference's functions map onto :class:`Transformer`:
``init_params`` is its constructor, ``forward`` its ``forward``,
``lm_head_matrix`` / ``lm_loss`` / ``init_cache`` / ``decode_step`` its
methods of those names.

Expert parallelism: a ``mesh`` (a
:class:`~repro_torch.runtime.sharding.CorpusMesh` with a ``model`` axis)
given to ``forward`` / ``decode_step`` runs every MoE layer of that call
through :func:`~repro_torch.models.moe.moe_apply_ep`, where the reference
switches on its module global ``layers.MESH``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from .layers import MLP, Attention, Norm, normal_param
from .mamba2 import Mamba2, mamba2_decode
from .moe import MoE, moe_apply_ep
from .rwkv6 import RWKV6TimeMix, rwkv6_decode

ATTN_FAMILIES = ("dense", "moe", "vlm", "audio")


def _largest_pow2_divisor_leq(t: int, cap: int) -> int:
    c = 1
    while c * 2 <= cap and t % (c * 2) == 0:
        c *= 2
    return c


def loss_chunk_len(seq_len: int, vocab: int, budget: int = 1 << 25) -> int:
    """Tokens per loss chunk so the logits slab stays ~budget elements."""
    return _largest_pow2_divisor_leq(seq_len, max(1, budget // vocab))


def _sqrt_factor(n: int) -> tuple[int, int, int]:
    """n = g * k + rem with g ~ sqrt(n): the two-level remat grouping."""
    g = max(1, int(n ** 0.5))
    while n // g == 0:
        g -= 1
    k = n // g
    return g, k, n - g * k


def _maybe_checkpoint(fn, remat: bool, *args):
    if not remat:
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def padded_vocab(cfg: ArchConfig, tp: int) -> int:
    """Megatron-style vocab padding: embeddings and logits shard over the
    model axis."""
    return -(-cfg.vocab_size // tp) * tp


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

    def _ffn(self, h: torch.Tensor, mesh=None):
        hn = self.norm2(h)
        if self.moe is not None:
            out, aux = (self.moe(hn) if mesh is None
                        else moe_apply_ep(self.moe, hn, mesh))
            return h + out, aux
        return h + self.mlp(hn), h.new_zeros(())

    def forward(self, h: torch.Tensor, block_k: int = 512, mesh=None):
        """The reference's ``_attn_mlp_block``: (h, aux); the MoE expert
        parallel over ``mesh`` when one is given."""
        h = h + self.attn(self.norm1(h), block_k)
        return self._ffn(h, mesh)

    def decode(self, h: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
               pos: int, mesh=None) -> torch.Tensor:
        """The reference's ``_attn_block_decode``; ck and cv are written in
        place."""
        h = h + self.attn.decode(self.norm1(h), ck, cv, pos)
        return self._ffn(h, mesh)[0]


class RWKVBlock(nn.Module):
    """Pre-norm [RWKV-6 time-mix + channel-mix] block; the channel-mix is a
    plain MLP of ``cfg.mlp`` (squared ReLU), with no token shift."""

    def __init__(self, cfg: ArchConfig, n_heads: int, generator, device,
                 dtype):
        super().__init__()
        d, s = cfg.d_model, cfg.ssm
        self.norm1 = Norm(cfg.norm, d, device, dtype)
        self.norm2 = Norm(cfg.norm, d, device, dtype)
        self.tmix = RWKV6TimeMix(d, s.head_dim, s.decay_lora, n_heads,
                                 generator, device, dtype)
        self.cmix = MLP(d, cfg.d_ff, cfg.mlp, generator, device, dtype)

    def forward(self, h: torch.Tensor, chunk: int) -> torch.Tensor:
        h = h + self.tmix(self.norm1(h), chunk)
        return h + self.cmix(self.norm2(h))

    def decode(self, h: torch.Tensor, shift: torch.Tensor,
               wkv: torch.Tensor) -> torch.Tensor:
        """shift (2, B, 1, d) and wkv (B, H, D, D) are written in place.
        Slot 0 of shift is the time-mix's previous input. Slot 1 takes the
        channel-mix's input, which nothing reads: the reference's layout
        (ROADMAP R11)."""
        hn = self.norm1(h)
        o, sh, s_new = rwkv6_decode(self.tmix, hn, shift[0], wkv,
                                    self.tmix.head_dim)
        h = h + o
        hn2 = self.norm2(h)
        shift[0].copy_(sh)
        shift[1].copy_(hn2)
        wkv.copy_(s_new)
        return h + self.cmix(hn2)


class MambaBlock(nn.Module):
    """Pre-norm Mamba2 block (residual, no MLP)."""

    def __init__(self, cfg: ArchConfig, generator, device, dtype):
        super().__init__()
        s = cfg.ssm
        self.norm = Norm(cfg.norm, cfg.d_model, device, dtype)
        self.mamba = Mamba2(cfg.d_model, s.d_state, s.head_dim, s.expand,
                            s.conv_width, generator, device, dtype)

    def forward(self, h: torch.Tensor, chunk: int) -> torch.Tensor:
        return h + self.mamba(self.norm(h), chunk)

    def decode(self, h: torch.Tensor, conv: torch.Tensor,
               ssm: torch.Tensor) -> torch.Tensor:
        """conv (B, W-1, C) and ssm (B, H, N, P) are written in place."""
        m = self.mamba
        o, c, s_new = mamba2_decode(m, self.norm(h), conv, ssm, m.d_state,
                                    m.head_dim)
        conv.copy_(c)
        ssm.copy_(s_new)
        return h + o


class Transformer(nn.Module):
    """The LM for ``cfg`` (any family), its parameters created on
    ``device`` (``cuda`` by default; raises without one) from ``generator``
    (a ``torch.Generator`` on that device, or an int seed). ``tp`` keeps
    the reference's shape rules: ``tp_heads`` head padding, rwkv6 head,
    expert and vocab padding. The hybrid holds its shared block once
    (``shared_block``), applied after each of its ``n_groups`` groups."""

    def __init__(self, cfg: ArchConfig, generator=0, tp: int = 1,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = (torch.device("meta") if str(device) == "meta"
                  else resolve_device(device))
        if isinstance(generator, int):
            generator = (torch.Generator(device=device).manual_seed(generator)
                         if device.type != "meta" else None)
        self.cfg, self.tp = cfg, tp
        d, n = cfg.d_model, cfg.num_layers
        self.n_q, self.n_kv = cfg.tp_heads(tp)
        vp = padded_vocab(cfg, tp)
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.embed = normal_param((vp, d), 0.02, **kw)
        self.final_norm = Norm(cfg.norm, d, device, dtype)
        self.lm_head = (None if cfg.tie_embeddings
                        else normal_param((vp, d), d ** -0.5, **kw))
        if cfg.family in ATTN_FAMILIES:
            layers = (Block(cfg, self.n_q, self.n_kv, generator, tp, device,
                            dtype) for _ in range(n))
        elif cfg.family == "ssm":
            n_heads = -(-(d // cfg.ssm.head_dim) // tp) * tp   # pad to tp
            layers = (RWKVBlock(cfg, n_heads, generator, device, dtype)
                      for _ in range(n))
        elif cfg.family == "hybrid":
            layers = (MambaBlock(cfg, generator, device, dtype)
                      for _ in range(n))
        else:
            raise ValueError(cfg.family)
        self.layers = nn.ModuleList(layers)
        self.n_groups = (n // cfg.attn_every if cfg.family == "hybrid"
                         else 0)
        self.shared_block = (Block(cfg, self.n_q, self.n_kv, generator, tp,
                                   device, dtype)
                             if cfg.family == "hybrid" else None)

    def lm_head_matrix(self) -> torch.Tensor:
        """(Vp, d), the ``nn.Linear`` layout (logits = ``F.linear(h, W)``):
        the embedding when tied, else the LM head."""
        return self.embed if self.lm_head is None else self.lm_head

    def forward(self, tokens: torch.Tensor, block_k: int = 512,
                remat: bool = False, mesh=None):
        """tokens (B, T) -> (hidden (B, T, d) after the final norm, aux
        load-balance loss summed over the layers; zero but for the MoE).
        ``remat`` checkpoints as the reference's ``forward(remat=True)``
        does; the result is the same either way. ``mesh`` runs the MoE
        layers expert parallel."""
        h = F.embedding(tokens, self.embed)
        bk = min(block_k, tokens.shape[1])
        if self.cfg.family == "hybrid":
            return self._hybrid(h, bk, remat)
        chunk = self.cfg.ssm.chunk if self.cfg.family == "ssm" else None

        def layer(blk):
            if chunk is not None:               # rwkv6: no aux
                return lambda h: (blk(h, chunk), h.new_zeros(()))
            return lambda h: blk(h, bk, mesh)

        def run(blks, h):
            """h through ``blks``, each checkpointed under remat: (h, the
            sum of their aux losses)."""
            auxs = []
            for blk in blks:
                h, a = _maybe_checkpoint(layer(blk), remat, h)
                auxs.append(a)
            return h, torch.stack(auxs).sum()

        # two_level_scan: g groups of k layers (each group checkpointed
        # too), then the rem layers that fill no group
        g, k, rem = _sqrt_factor(len(self.layers))
        auxs = []
        for i in range(g):
            blks = self.layers[i * k:(i + 1) * k]
            h, a = _maybe_checkpoint(lambda h, blks=blks: run(blks, h),
                                     remat, h)
            auxs.append(a)
        aux = torch.stack(auxs).sum()
        if rem:
            h, a = run(self.layers[g * k:], h)
            aux = aux + a
        return self.final_norm(h), aux

    def _hybrid(self, h: torch.Tensor, bk: int, remat: bool):
        """Each group's Mamba2 layers (each checkpointed under remat), then
        the shared block, the group checkpointed as a whole; then the
        layers that fill no group."""
        chunk, k = self.cfg.ssm.chunk, self.cfg.attn_every

        def mamba(blks, h):
            for blk in blks:
                h = _maybe_checkpoint(lambda h, blk=blk: blk(h, chunk),
                                      remat, h)
            return h

        def group(blks, h):
            return self.shared_block(mamba(blks, h), bk)[0]

        for i in range(self.n_groups):
            blks = self.layers[i * k:(i + 1) * k]
            h = _maybe_checkpoint(lambda h, blks=blks: group(blks, h),
                                  remat, h)
        h = mamba(self.layers[self.n_groups * k:], h)
        return self.final_norm(h), h.new_zeros(())

    def lm_loss(self, hidden: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
        """Mean softmax cross-entropy of ``labels`` (B, T) under the
        logits of ``hidden`` (B, T, d), chunked over T as the reference's
        (``loss_chunk_len`` positions a chunk: a bounded logits slab);
        padded vocabulary rows are masked out. fp32 scalar."""
        b, t, _ = hidden.shape
        head = self.lm_head_matrix()
        vp, v = head.shape[0], self.cfg.vocab_size
        ct = loss_chunk_len(t, v)
        pad = None
        if vp != v:
            pad = (torch.arange(vp, device=hidden.device) >= v) * -1e30
        tot = hidden.new_zeros((), dtype=torch.float32)
        for c in range(0, t, ct):
            z = F.linear(hidden[:, c:c + ct], head).float()   # (B, ct, Vp)
            if pad is not None:
                z = z + pad
            gold = z.gather(-1, labels[:, c:c + ct, None].long())[..., 0]
            tot = tot + (torch.logsumexp(z, -1) - gold).sum()
        return tot / (b * t)

    def init_cache(self, batch: int, max_len: int) -> dict:
        """Zero-filled serve cache on the model's device with the
        reference's keys and shapes, and ``pos`` (the next position, a host
        int). Attention families: k and v (L, B, n_kv, max_len, hd). ssm:
        shift (L, 2, B, 1, d) and wkv (L, B, H, D, D). hybrid: conv (G, k,
        B, W-1, C) and ssm (G, k, B, H, N, P) for the G groups of k layers,
        conv_rem and ssm_rem for the rest, and k and v (G, B, n_kv,
        max_len, hd), one per application of the shared block."""
        cfg, w = self.cfg, self.embed

        def zeros(*shape):
            return torch.zeros(shape, dtype=w.dtype, device=w.device)

        cache = {"pos": 0}
        kv = (batch, self.n_kv, max_len, cfg.head_dim)
        if cfg.family in ATTN_FAMILIES:
            cache["k"] = zeros(cfg.num_layers, *kv)
            cache["v"] = zeros(cfg.num_layers, *kv)
        elif cfg.family == "ssm":
            hd = cfg.ssm.head_dim
            n_heads = self.layers[0].tmix.u.shape[0]
            cache["shift"] = zeros(cfg.num_layers, 2, batch, 1, cfg.d_model)
            cache["wkv"] = zeros(cfg.num_layers, batch, n_heads, hd, hd)
        else:
            s = cfg.ssm
            g, k = self.n_groups, cfg.attn_every
            n_rem = cfg.num_layers - g * k
            d_in = s.expand * cfg.d_model
            conv = (batch, s.conv_width - 1, d_in + 2 * s.d_state)
            ssm = (batch, d_in // s.head_dim, s.d_state, s.head_dim)
            cache["conv"] = zeros(g, k, *conv)
            cache["ssm"] = zeros(g, k, *ssm)
            if n_rem:
                cache["conv_rem"] = zeros(n_rem, *conv)
                cache["ssm_rem"] = zeros(n_rem, *ssm)
            cache["k"] = zeros(g, *kv)
            cache["v"] = zeros(g, *kv)
        return cache

    def decode_step(self, cache: dict, tokens: torch.Tensor, mesh=None):
        """One-token decode. tokens (B, 1) -> (logits (B, V) fp32, cache).
        The cache's states are written in place and ``pos`` advances.
        ``mesh`` runs the MoE layers expert parallel."""
        pos = cache["pos"]
        h = F.embedding(tokens, self.embed)
        family = self.cfg.family
        if family in ATTN_FAMILIES:
            for i, blk in enumerate(self.layers):
                h = blk.decode(h, cache["k"][i], cache["v"][i], pos, mesh)
        elif family == "ssm":
            for i, blk in enumerate(self.layers):
                h = blk.decode(h, cache["shift"][i], cache["wkv"][i])
        else:
            k = self.cfg.attn_every
            n_full = self.n_groups * k
            for i, blk in enumerate(self.layers):
                if i >= n_full:
                    h = blk.decode(h, cache["conv_rem"][i - n_full],
                                   cache["ssm_rem"][i - n_full])
                    continue
                g, e = divmod(i, k)
                h = blk.decode(h, cache["conv"][g, e], cache["ssm"][g, e])
                if e == k - 1:
                    h = self.shared_block.decode(h, cache["k"][g],
                                                 cache["v"][g], pos)
        h = self.final_norm(h)
        logits = F.linear(h[:, 0], self.lm_head_matrix()).float()
        cache["pos"] = pos + 1
        return logits[:, :self.cfg.vocab_size], cache   # drop padded rows
