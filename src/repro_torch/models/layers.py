"""Transformer layers of the port: norms, RoPE, GQA attention (an
online-softmax flash attention over key blocks with its own backward,
and its materialized twin), MLP variants (port of ``repro.models.layers``).

Dense projections are stored as ``nn.Linear`` weights, (out, in), and
applied with ``F.linear``; ``repro_torch.models.convert`` transposes the
reference's (in, out) matrices into that layout. Every parameter is
created on its device with an explicit dtype and drawn from an explicit
``torch.Generator``. Query heads are kv-major, as in the reference: q is
reshaped to (B, T, n_kv, g, hd), so query head ``j * g + i`` belongs to kv
head ``j``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e30


def normal_param(shape, std: float, generator, device, dtype) -> nn.Parameter:
    """N(0, std^2) parameter drawn on ``device`` from ``generator`` (a
    generator on that device); left uninitialized on the ``meta`` device,
    where ``repro_torch.models.convert`` assigns carried weights."""
    t = torch.empty(shape, device=device, dtype=dtype)
    if t.device.type != "meta":
        t.normal_(0.0, std, generator=generator)
    return nn.Parameter(t)


# ----------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """The variance in fp32; rsqrt cast to x's dtype before the scale."""
    var = x.float().square().mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps).to(x.dtype) * scale.to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Population variance (``jnp.var``), in fp32."""
    out = F.layer_norm(x.float(), x.shape[-1:], eps=eps).to(x.dtype)
    return out * scale.to(x.dtype) + bias.to(x.dtype)


class Norm(nn.Module):
    """``rmsnorm`` (scale) or ``layernorm`` (scale and bias)."""

    def __init__(self, kind: str, d: int, device=None, dtype=torch.float32):
        super().__init__()
        if kind not in ("rmsnorm", "layernorm"):
            raise ValueError(kind)
        self.kind = kind
        self.scale = nn.Parameter(torch.ones(d, device=device, dtype=dtype))
        if kind == "layernorm":
            self.bias = nn.Parameter(torch.zeros(d, device=device,
                                                 dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "rmsnorm":
            return rmsnorm(x, self.scale)
        return layernorm(x, self.scale, self.bias)


# ----------------------------------------------------------------- RoPE
def rope_frequencies(head_dim: int, theta: float, positions: torch.Tensor):
    """positions (T,) -> cos/sin (T, head_dim/2), fp32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    ang = positions.float()[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., T, D); cos/sin (T, D/2). Rotate-half convention."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos.to(x.dtype)
    s = sin.to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ------------------------------------------------- flash attention (GQA)
def _causal_mask(causal: bool, q_offset: int, start: int, tq: int, bk: int,
                 device):
    """True where key ``start + j`` lies after query ``q_offset + i``."""
    if not causal:
        return None
    q_pos = q_offset + torch.arange(tq, device=device)
    k_pos = start + torch.arange(bk, device=device)
    return k_pos[None, :] > q_pos[:, None]


def _acc_dtype(q: torch.Tensor) -> torch.dtype:
    """fp32 accumulation (fp64 for fp64 inputs)."""
    return torch.promote_types(q.dtype, torch.float32)


def _block_scores(q, kb, scale, causal, q_offset, start):
    s = torch.einsum("bghqd,bhkd->bghqk", q, kb).to(_acc_dtype(q)) * scale
    hide = _causal_mask(causal, q_offset, start, q.shape[3], kb.shape[2],
                        q.device)
    return s if hide is None else s.masked_fill(hide, NEG_INF)


def _flash_fwd(q, k, v, causal, q_offset, block_k):
    """(out, lse): the online softmax over key blocks."""
    b, g, hkv, tq, d = q.shape
    tk = k.shape[2]
    if tk % block_k:
        raise ValueError(f"Tk={tk} does not divide by block_k={block_k}")
    scale = 1.0 / math.sqrt(d)
    acc = _acc_dtype(q)
    o = torch.zeros((b, g, hkv, tq, d), dtype=acc, device=q.device)
    m = torch.full((b, g, hkv, tq), NEG_INF, dtype=acc, device=q.device)
    denom = torch.zeros((b, g, hkv, tq), dtype=acc, device=q.device)
    for start in range(0, tk, block_k):
        kb = k[:, :, start:start + block_k]
        vb = v[:, :, start:start + block_k]
        s = _block_scores(q, kb, scale, causal, q_offset, start)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        denom = denom * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum(
            "bghqk,bhkd->bghqd", p.to(v.dtype), vb).to(acc)
        m = m_new
    return (o / denom[..., None]).to(q.dtype), m + torch.log(denom)


class FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward saves (q, k, v, out,
    lse) and the backward recomputes each key block's probabilities from
    lse, so neither pass keeps more than one block of scores."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, block_k):
        out, lse = _flash_fwd(q, k, v, causal, q_offset, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset, block_k = ctx.args
        scale = 1.0 / math.sqrt(q.shape[-1])
        acc = _acc_dtype(q)
        delta = (dout.to(acc) * out.to(acc)).sum(-1)        # (b, g, h, q)
        dq = torch.zeros(q.shape, dtype=acc, device=q.device)
        dk = torch.empty_like(k)
        dv = torch.empty_like(v)
        for start in range(0, k.shape[2], block_k):
            kb = k[:, :, start:start + block_k]
            vb = v[:, :, start:start + block_k]
            s = _block_scores(q, kb, scale, causal, q_offset, start)
            p = torch.exp(s - lse[..., None])                # recompute
            dp = torch.einsum("bghqd,bhkd->bghqk", dout.to(acc), vb.to(acc))
            ds = p * (dp - delta[..., None]) * scale
            dq += torch.einsum("bghqk,bhkd->bghqd", ds.to(q.dtype),
                               kb).to(acc)
            dk[:, :, start:start + block_k] = torch.einsum(
                "bghqk,bghqd->bhkd", ds.to(q.dtype), q)
            dv[:, :, start:start + block_k] = torch.einsum(
                "bghqk,bghqd->bhkd", p.to(dout.dtype), dout)
        return dq.to(q.dtype), dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, q_offset: int = 0,
                    block_k: int = 512) -> torch.Tensor:
    """Online-softmax attention over key blocks of ``block_k``: live
    memory O(Tq * block_k), not O(Tq * Tk), in the forward and (through
    :class:`FlashAttention`) the backward.

    q: (B, G, Hkv, Tq, D), Hq = G * Hkv query heads grouped by kv head;
    k, v: (B, Hkv, Tk, D). Returns (B, G, Hkv, Tq, D). Tk must divide by
    ``block_k``; ``q_offset`` is the absolute position of q[..., 0, :].
    """
    return FlashAttention.apply(q, k, v, causal, q_offset, block_k)


def attention_ref(q, k, v, causal: bool = True,
                  q_offset: int = 0) -> torch.Tensor:
    """Twin of :func:`flash_attention` that materializes the scores."""
    d = q.shape[-1]
    s = torch.einsum("bghqd,bhkd->bghqk", q, k).float() / math.sqrt(d)
    if causal:
        tq, tk = q.shape[-2], k.shape[-2]
        q_pos = q_offset + torch.arange(tq, device=q.device)
        k_pos = torch.arange(tk, device=q.device)
        s = s.masked_fill(k_pos[None, :] > q_pos[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bghqk,bhkd->bghqd", p.to(v.dtype), v)


# ---------------------------------------------------------------- attention
class Attention(nn.Module):
    """GQA self-attention with RoPE; ``n_q`` and ``n_kv`` are the
    TP-adjusted (padded or replicated) head counts."""

    def __init__(self, d_model: int, n_q: int, n_kv: int, head_dim: int,
                 qkv_bias: bool, rope_theta: float | None, generator,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.n_q, self.n_kv, self.head_dim = n_q, n_kv, head_dim
        self.rope_theta = rope_theta
        s = d_model ** -0.5
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.wq = normal_param((n_q * head_dim, d_model), s, **kw)
        self.wk = normal_param((n_kv * head_dim, d_model), s, **kw)
        self.wv = normal_param((n_kv * head_dim, d_model), s, **kw)
        self.wo = normal_param((d_model, n_q * head_dim), s, **kw)
        if qkv_bias:
            self.bq = nn.Parameter(torch.zeros(n_q * head_dim, device=device,
                                               dtype=dtype))
            self.bk = nn.Parameter(torch.zeros(n_kv * head_dim,
                                               device=device, dtype=dtype))
            self.bv = nn.Parameter(torch.zeros(n_kv * head_dim,
                                               device=device, dtype=dtype))
        else:
            self.bq = self.bk = self.bv = None

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """x (B, T, d) -> q (B, g, n_kv, T, hd), k and v (B, n_kv, T, hd),
        kv-major, RoPE applied at ``positions``."""
        b, t, _ = x.shape
        g = self.n_q // self.n_kv
        hd = self.head_dim
        q = F.linear(x, self.wq, self.bq)
        k = F.linear(x, self.wk, self.bk)
        v = F.linear(x, self.wv, self.bv)
        q = q.reshape(b, t, self.n_kv, g, hd).permute(0, 3, 2, 1, 4)
        k = k.reshape(b, t, self.n_kv, hd).transpose(1, 2)
        v = v.reshape(b, t, self.n_kv, hd).transpose(1, 2)
        if self.rope_theta is not None:
            cos, sin = rope_frequencies(hd, self.rope_theta, positions)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        return q, k, v

    def _out(self, o: torch.Tensor) -> torch.Tensor:
        """(B, g, n_kv, T, hd) back to the kv-major flat layout, then wo."""
        b, _, _, t, _ = o.shape
        o = o.permute(0, 3, 2, 1, 4).reshape(b, t, self.n_q * self.head_dim)
        return F.linear(o, self.wo)

    def forward(self, x: torch.Tensor, block_k: int = 512) -> torch.Tensor:
        """Causal self-attention over a whole sequence (prefill); the
        reference's ``attention_train``. x: (B, T, d)."""
        t = x.shape[1]
        q, k, v = self._qkv(x, torch.arange(t, device=x.device))
        return self._out(flash_attention(q, k, v, True, 0, min(block_k, t)))

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, pos: int) -> torch.Tensor:
        """One-token decode (the reference's ``attention_decode``).

        x: (B, 1, d); cache_k/v: (B, n_kv, S, hd), written in place at
        ``pos`` (the number of valid entries, the absolute position of this
        token). Indexing past S raises; the reference's
        ``dynamic_update_slice`` would clamp and overwrite the last slot.
        """
        s_len = cache_k.shape[2]
        if not 0 <= pos < s_len:
            raise IndexError(f"decode position {pos} outside the KV cache "
                             f"of {s_len} slots")
        q, k, v = self._qkv(x, torch.arange(pos, pos + 1, device=x.device))
        cache_k[:, :, pos:pos + 1] = k.to(cache_k.dtype)
        cache_v[:, :, pos:pos + 1] = v.to(cache_v.dtype)
        scores = torch.einsum("bghqd,bhkd->bghqk", q, cache_k).float() \
            / math.sqrt(self.head_dim)
        scores[..., pos + 1:] = NEG_INF              # positions 0..pos live
        pr = torch.softmax(scores, dim=-1)
        o = torch.einsum("bghqk,bhkd->bghqd", pr.to(cache_v.dtype), cache_v)
        return self._out(o)


# ----------------------------------------------------------------- MLPs
class MLP(nn.Module):
    """``swiglu`` (w_gate, w_up, w_down), ``squared_relu`` (nemotron-4) or
    ``gelu`` (tanh approximation, ``jax.nn.gelu``'s default)."""

    def __init__(self, d_model: int, d_ff: int, kind: str, generator,
                 device=None, dtype=torch.float32):
        super().__init__()
        if kind not in ("swiglu", "squared_relu", "gelu"):
            raise ValueError(kind)
        self.kind = kind
        s_in, s_out = d_model ** -0.5, d_ff ** -0.5
        kw = dict(generator=generator, device=device, dtype=dtype)
        if kind == "swiglu":
            self.w_gate = normal_param((d_ff, d_model), s_in, **kw)
            self.w_up = normal_param((d_ff, d_model), s_in, **kw)
            self.w_down = normal_param((d_model, d_ff), s_out, **kw)
        else:
            self.w_in = normal_param((d_ff, d_model), s_in, **kw)
            self.w_out = normal_param((d_model, d_ff), s_out, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "swiglu":
            return F.linear(F.silu(F.linear(x, self.w_gate))
                            * F.linear(x, self.w_up), self.w_down)
        h = F.linear(x, self.w_in)
        if self.kind == "squared_relu":
            h = F.relu(h)
            return F.linear(h * h, self.w_out)
        return F.linear(F.gelu(h, approximate="tanh"), self.w_out)
