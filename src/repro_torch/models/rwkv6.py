"""RWKV-6 time-mix of the port (port of ``repro.models.rwkv6``): linear
attention with a data-dependent diagonal decay, evaluated in chunks.

Per head (key and value dim D), with decay w_t in (0, 1)^D and bonus u:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t            S: (D, D)
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

Within a chunk every pairwise decay is exp(cum_excl[t] - cum[s]) with
``cum`` the inclusive cumsum of log w, which decreases, so every exponent
of a live pair is <= 0. The token-shift mix is static (``mu``); only the
decay LoRA depends on the data. The output norm is an RMS norm over all
of ``d_attn`` (eps 1e-6), as the reference's ``_out`` computes it.

The plain functions take the :class:`RWKV6TimeMix` module for the
reference's parameter dict; its matrices are in the ``nn.Linear`` layout
(out, in).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import normal_param, rmsnorm


class RWKV6TimeMix(nn.Module):
    """The reference's ``init_rwkv6``. ``n_heads`` may exceed ``d_model //
    head_dim`` (tp padding); then ``d_attn = n_heads * head_dim`` differs
    from ``d_model`` and ``wo`` and ``ln_scale`` follow ``d_attn``."""

    def __init__(self, d_model: int, head_dim: int = 64, decay_lora: int = 64,
                 n_heads: int | None = None, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        n_heads = d_model // head_dim if n_heads is None else n_heads
        d_attn = n_heads * head_dim
        self.head_dim = head_dim
        s = d_model ** -0.5
        kw = dict(generator=generator, device=device, dtype=dtype)
        full = dict(device=device, dtype=dtype)
        self.mu = nn.Parameter(torch.full((5, d_model), 0.5, **full))
        self.wr = normal_param((d_attn, d_model), s, **kw)
        self.wk = normal_param((d_attn, d_model), s, **kw)
        self.wv = normal_param((d_attn, d_model), s, **kw)
        self.wg = normal_param((d_attn, d_model), s, **kw)
        self.wo = normal_param((d_model, d_attn), d_attn ** -0.5, **kw)
        # decay LoRA: w = exp(-exp(w0 + tanh(x w1) w2))
        self.w0 = nn.Parameter(torch.full((d_attn,), -1.0, **full))
        self.w1 = normal_param((decay_lora, d_model), s, **kw)
        self.w2 = normal_param((d_attn, decay_lora), decay_lora ** -0.5, **kw)
        self.u = normal_param((n_heads, head_dim), 0.1, **kw)
        self.ln_scale = nn.Parameter(torch.ones(d_attn, **full))

    def forward(self, x: torch.Tensor, chunk: int = 64) -> torch.Tensor:
        return rwkv6_train(self, x, self.head_dim, chunk)


def _mix(x, x_shift, mu):
    return x + mu * (x_shift - x)


def _proj_rkvwg(p: RWKV6TimeMix, x, x_shift, n_heads: int, head_dim: int):
    b, t, _ = x.shape
    r = F.linear(_mix(x, x_shift, p.mu[0]), p.wr)
    k = F.linear(_mix(x, x_shift, p.mu[1]), p.wk)
    v = F.linear(_mix(x, x_shift, p.mu[2]), p.wv)
    xw = _mix(x, x_shift, p.mu[3])
    g = F.silu(F.linear(_mix(x, x_shift, p.mu[4]), p.wg))
    logw = -torch.exp(p.w0 + F.linear(torch.tanh(F.linear(xw, p.w1)),
                                      p.w2))                      # < 0
    shp = (b, t, n_heads, head_dim)
    return (r.reshape(shp), k.reshape(shp), v.reshape(shp),
            logw.reshape(shp), g)


def _out(p: RWKV6TimeMix, o, g, b: int, t: int) -> torch.Tensor:
    return F.linear(rmsnorm(o.reshape(b, t, -1), p.ln_scale) * g, p.wo)


def _shifted(x: torch.Tensor) -> torch.Tensor:
    """The previous token's input, zero before the first."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def check_chunk(t: int, chunk: int) -> int:
    """The chunk the scans use, ``min(chunk, t)``; raises where ``t`` does
    not divide by it (the reference fails in a reshape there)."""
    chunk = min(chunk, t)
    if t % chunk:
        raise ValueError(f"sequence length T={t} does not divide by the "
                         f"chunk {chunk}")
    return chunk


def rwkv6_train(p: RWKV6TimeMix, x: torch.Tensor, head_dim: int = 64,
                chunk: int = 64) -> torch.Tensor:
    """Full-sequence chunked WKV6. x (B, T, d); T % min(chunk, T) == 0."""
    b, t, _ = x.shape
    chunk = check_chunk(t, chunk)
    n_heads = p.wo.shape[1] // head_dim
    r, k, v, logw, g = _proj_rkvwg(p, x, _shifted(x), n_heads, head_dim)
    nc = t // chunk

    def chunks(a):                                  # (nc, B, H, c, D)
        return a.reshape(b, nc, chunk, n_heads, head_dim) \
            .permute(1, 0, 3, 2, 4)

    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device), diagonal=-1)[:, :, None]
    eye = torch.eye(chunk, dtype=x.dtype, device=x.device)
    u = p.u[None, :, None, :]
    s = x.new_zeros((b, n_heads, head_dim, head_dim))
    outs = []
    for rc, kc, vc, lwc in zip(chunks(r), chunks(k), chunks(v),
                               chunks(logw)):
        cum = lwc.cumsum(2)                         # inclusive, decreasing
        cum_excl = cum - lwc                        # log w up to t - 1
        # inter-chunk: o_t = (r_t * exp(cum_excl[t])) @ S0
        o = (rc * torch.exp(cum_excl)) @ s
        # intra-chunk, s < t: A[t, s] = sum_d r[t,d] k[s,d]
        # exp(cum_excl[t,d] - cum[s,d]); the diagonal takes the bonus u
        ddiff = cum_excl[:, :, :, None, :] - cum[:, :, None, :, :]
        # clamp before exp: masked pairs have ddiff >= 0
        dec = torch.where(tri, torch.exp(torch.where(tri, ddiff, 0.0)), 0.0)
        amat = torch.einsum("bhtsd,bhsd->bhts", rc[:, :, :, None, :] * dec,
                            kc)
        diag = (rc * u * kc).sum(-1)
        o = o + (amat + diag[..., None] * eye) @ vc
        # S = exp(cum[-1]) S0 + sum_s exp(cum[-1] - cum[s]) k_s^T v_s
        dec_end = torch.exp(cum[:, :, -1:, :] - cum)
        s = torch.exp(cum[:, :, -1])[..., None] * s \
            + (kc * dec_end).transpose(-1, -2) @ vc
        outs.append(o)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(
        b, t, n_heads, head_dim)
    return _out(p, o, g, b, t)


def rwkv6_decode(p: RWKV6TimeMix, x: torch.Tensor, shift_state: torch.Tensor,
                 wkv_state: torch.Tensor, head_dim: int = 64):
    """One token. x (B, 1, d); shift_state (B, 1, d), the previous token's
    input; wkv_state (B, H, D, D). Returns (out, new_shift, new_wkv)."""
    b = x.shape[0]
    n_heads = p.wo.shape[1] // head_dim
    r, k, v, logw, g = _proj_rkvwg(p, x, shift_state, n_heads, head_dim)
    r1, k1, v1, lw1 = r[:, 0], k[:, 0], v[:, 0], logw[:, 0]   # (B, H, D)
    kv = k1[..., :, None] * v1[..., None, :]
    o = (r1[..., None, :] @ (wkv_state + p.u[None, :, :, None] * kv))
    s_new = torch.exp(lw1)[..., None] * wkv_state + kv
    return _out(p, o[:, None, :, 0], g, b, 1), x, s_new


def rwkv6_ref(p: RWKV6TimeMix, x: torch.Tensor,
              head_dim: int = 64) -> torch.Tensor:
    """Step-by-step oracle of :func:`rwkv6_train`."""
    b, t, _ = x.shape
    n_heads = p.wo.shape[1] // head_dim
    r, k, v, logw, g = _proj_rkvwg(p, x, _shifted(x), n_heads, head_dim)
    u = p.u[None, :, :, None]
    s = x.new_zeros((b, n_heads, head_dim, head_dim))
    outs = []
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]
        outs.append((r[:, i, :, None, :] @ (s + u * kv))[:, :, 0])
        s = torch.exp(logw[:, i])[..., None] * s + kv
    return _out(p, torch.stack(outs, 1), g, b, t)
