"""Mamba2 (SSD) block of the port (port of ``repro.models.mamba2``): a
state-space recurrence evaluated in chunks.

Per head h, with scalar decay a_t = exp(dt_t * A_h):

    S_t = a_t * S_{t-1} + dt_t * B_t x_t^T          S: (N, P)
    y_t = C_t . S_t + D_h * x_t

Within a chunk of length c the pairwise decay L[t, s] = exp(cum[t] -
cum[s]) (s <= t, so <= 1) gives the intra-chunk term; the state carries
across chunks in a loop. The projections are split (``w_z``, ``w_x``,
``w_dt`` per head; ``w_bc`` shared by the heads, one group), each a
matrix in the ``nn.Linear`` layout (out, in). The plain functions take the
:class:`Mamba2` module for the reference's parameter dict.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import normal_param, rmsnorm
from .rwkv6 import check_chunk


class Mamba2(nn.Module):
    """The reference's ``init_mamba2``: d_inner = expand * d_model split
    into d_inner / head_dim heads, a causal depthwise conv of
    ``conv_width`` on the x and the B/C channels."""

    def __init__(self, d_model: int, d_state: int = 64, head_dim: int = 64,
                 expand: int = 2, conv_width: int = 4, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        d_inner = expand * d_model
        n_heads = d_inner // head_dim
        self.d_state, self.head_dim = d_state, head_dim
        s = d_model ** -0.5
        kw = dict(generator=generator, device=device, dtype=dtype)
        full = dict(device=device, dtype=dtype)
        self.w_z = normal_param((d_inner, d_model), s, **kw)
        self.w_x = normal_param((d_inner, d_model), s, **kw)
        self.w_bc = normal_param((2 * d_state, d_model), s, **kw)
        self.w_dt = normal_param((n_heads, d_model), s, **kw)
        self.conv_x = normal_param((conv_width, d_inner), 0.2, **kw)
        self.conv_bc = normal_param((conv_width, 2 * d_state), 0.2, **kw)
        self.conv_bias_x = nn.Parameter(torch.zeros(d_inner, **full))
        self.conv_bias_bc = nn.Parameter(torch.zeros(2 * d_state, **full))
        self.a_log = nn.Parameter(torch.log(torch.linspace(
            1.0, 16.0, n_heads, **full)))
        self.d_skip = nn.Parameter(torch.ones(n_heads, **full))
        self.dt_bias = nn.Parameter(torch.zeros(n_heads, **full))
        self.norm_scale = nn.Parameter(torch.ones(d_inner, **full))
        self.out_proj = normal_param((d_model, d_inner), d_inner ** -0.5,
                                     **kw)

    def forward(self, x: torch.Tensor, chunk: int = 128) -> torch.Tensor:
        return mamba2_train(self, x, self.d_state, self.head_dim, chunk)


def _causal_conv(x, w, bias):
    """Depthwise causal conv of width W: (B, T, C), (W, C) -> (B, T, C)."""
    width, t = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + t, :] * w[i] for i in range(width))
    return F.silu(out + bias)


def _gated_out(p: Mamba2, y, z):
    return F.linear(rmsnorm(y * F.silu(z), p.norm_scale), p.out_proj)


def _ssm_inputs(p: Mamba2, xin, d_state: int, head_dim: int):
    """z, the conv'd x per head (B, T, H, P), B and C (B, T, N) and dt
    (B, T, H) of a whole sequence."""
    b, t, _ = xin.shape
    z = F.linear(xin, p.w_z)
    xs = _causal_conv(F.linear(xin, p.w_x), p.conv_x, p.conv_bias_x)
    bc = _causal_conv(F.linear(xin, p.w_bc), p.conv_bc, p.conv_bias_bc)
    xs = xs.reshape(b, t, -1, head_dim)
    dt = F.softplus(F.linear(xin, p.w_dt) + p.dt_bias)
    return z, xs, bc[..., :d_state], bc[..., d_state:], dt


def mamba2_train(p: Mamba2, xin: torch.Tensor, d_state: int = 64,
                 head_dim: int = 64, chunk: int = 128) -> torch.Tensor:
    """Full-sequence chunked SSD. xin (B, T, d); T % min(chunk, T) == 0."""
    b, t, _ = xin.shape
    chunk = check_chunk(t, chunk)
    d_inner = p.out_proj.shape[1]
    n_heads = d_inner // head_dim
    z, xs, bmat, cmat, dt = _ssm_inputs(p, xin, d_state, head_dim)
    da = dt * -torch.exp(p.a_log)                              # <= 0

    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xin.device))[None, :, :, None]
    s = xin.new_zeros((b, n_heads, d_state, head_dim))
    ys = []
    for c0 in range(0, t, chunk):
        sl = slice(c0, c0 + chunk)
        xc, bcv, ccv = xs[:, sl], bmat[:, sl], cmat[:, sl]
        dtc = dt[:, sl]                                        # (B, c, H)
        cum = da[:, sl].cumsum(1)
        # intra: L[t, s] = exp(cum[t] - cum[s]) for s <= t (exponents <= 0)
        ldiff = cum[:, :, None, :] - cum[:, None, :, :]        # (B, c, c, H)
        # clamp before exp: masked (s > t) pairs have ldiff >= 0
        l_mat = torch.where(tri, torch.exp(torch.where(tri, ldiff, 0.0)),
                            0.0)
        cb = ccv @ bcv.transpose(1, 2)                         # (B, c, c)
        # pairwise, so no (B, c, c, H, P) product is formed
        wts = cb[..., None] * l_mat * dtc[:, None, :, :]       # (B, t, s, H)
        y = torch.einsum("btsh,bshp->bthp", wts, xc)
        # inter: y += exp(cum[t]) * C_t . S0
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "btn,bhnp->bthp", ccv, s)
        # S = exp(cum[-1]) S0 + sum_s exp(cum[-1] - cum[s]) dt_s B_s x_s^T
        dec = torch.exp(cum[:, -1:, :] - cum)                  # (B, c, H)
        s = torch.exp(cum[:, -1])[:, :, None, None] * s + torch.einsum(
            "bsn,bshp->bhnp", bcv, (dec * dtc)[..., None] * xc)
        ys.append(y)
    y = torch.cat(ys, 1) + p.d_skip[None, None, :, None] * xs
    return _gated_out(p, y.reshape(b, t, d_inner), z)


def mamba2_decode(p: Mamba2, xin: torch.Tensor, conv_state: torch.Tensor,
                  ssm_state: torch.Tensor, d_state: int = 64,
                  head_dim: int = 64):
    """One step. xin (B, 1, d); conv_state (B, W-1, C_x + C_bc), the x
    channels first; ssm_state (B, H, N, P). Returns (y (B, 1, d),
    conv_state', ssm_state')."""
    b = xin.shape[0]
    d_inner = p.out_proj.shape[1]
    n_heads = d_inner // head_dim
    z = F.linear(xin, p.w_z)
    xbc_new = torch.cat([F.linear(xin, p.w_x), F.linear(xin, p.w_bc)], -1)
    win = torch.cat([conv_state, xbc_new], 1)                  # (B, W, C)
    w_cat = torch.cat([p.conv_x, p.conv_bc], 1)
    bias = torch.cat([p.conv_bias_x, p.conv_bias_bc])
    conv = F.silu((win * w_cat).sum(1) + bias)

    xs = conv[:, :d_inner].reshape(b, n_heads, head_dim)
    bvec = conv[:, d_inner:d_inner + d_state]                  # (B, N)
    cvec = conv[:, d_inner + d_state:]
    dt1 = F.softplus(F.linear(xin, p.w_dt)[:, 0] + p.dt_bias)  # (B, H)
    decay = torch.exp(dt1 * -torch.exp(p.a_log))
    s_new = decay[:, :, None, None] * ssm_state \
        + dt1[:, :, None, None] * bvec[:, None, :, None] * xs[:, :, None, :]
    y = (cvec[:, None, None, :] @ s_new)[:, :, 0]              # (B, H, P)
    y = y + p.d_skip[None, :, None] * xs
    return (_gated_out(p, y.reshape(b, 1, d_inner), z), win[:, 1:],
            s_new)


def mamba2_ref(p: Mamba2, xin: torch.Tensor, d_state: int = 64,
               head_dim: int = 64) -> torch.Tensor:
    """Step-by-step oracle of :func:`mamba2_train`."""
    b, t, _ = xin.shape
    d_inner = p.out_proj.shape[1]
    z, xs, bmat, cmat, dt = _ssm_inputs(p, xin, d_state, head_dim)
    a = -torch.exp(p.a_log)
    s = xin.new_zeros((b, d_inner // head_dim, d_state, head_dim))
    ys = []
    for i in range(t):
        dti = dt[:, i, :, None, None]
        s = torch.exp(dti * a[:, None, None]) * s \
            + dti * bmat[:, i, None, :, None] * xs[:, i, :, None, :]
        ys.append((cmat[:, i, None, None, :] @ s)[:, :, 0])
    y = torch.stack(ys, 1) + p.d_skip[None, None, :, None] * xs
    return _gated_out(p, y.reshape(b, t, d_inner), z)
