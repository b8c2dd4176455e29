"""Mixture-of-Experts layer of the port: shared + routed experts, top-k
dispatch with capacity (port of ``repro.models.moe``, single device).

Router options: ``topk`` (softmax) or ``sinkhorn``, the paper's
Sinkhorn-Knopp solver as a balanced-assignment router
(``repro_torch.core.router``).

Dispatch is scatter-based, as the reference's: tokens are scattered into
an (E, C, d) capacity buffer by (expert, rank within expert), the experts
run as one ``torch.bmm`` per projection over stacked (E, d, f) weights,
and the results gather back. Assignments past capacity are dropped. Every
expert runs on its whole buffer, so a step reads every expert's weights
whatever the routing.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MoESpec
from repro_torch.core.router import route
from .layers import MLP, normal_param


def padded_experts(n_experts: int, tp: int) -> int:
    """Experts shard over the model axis: the count is padded up to a tp
    multiple (qwen2-moe: 60 -> 64 at TP=16). Padded experts are
    router-masked and carry zero Sinkhorn column marginal, so they never
    receive tokens."""
    return -(-n_experts // tp) * tp


class Dispatch(NamedTuple):
    """One layer's routing of n tokens: ``probs`` (n, E), ``topw`` and
    ``topi`` (n, k), and per assignment in token-major order (n * k,):
    ``rank`` within its expert and ``keep`` (1 kept, 0 dropped)."""
    probs: torch.Tensor
    topw: torch.Tensor
    topi: torch.Tensor
    rank: torch.Tensor
    keep: torch.Tensor
    cap: int


def capacity(n: int, top_k: int, e: int, capacity_factor: float,
             n_real: int | None = None) -> int:
    """Slots per expert: ``int(capacity_factor * top_k * n / (n_real or e)
    + 1)``, truncated as the reference does."""
    return int(capacity_factor * top_k * n / (n_real or e) + 1)


def top_k_stable(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest in descending order, ties to the lower
    index (a stable descending sort; ``torch.topk``'s tie order is
    unspecified)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def one_hot(idx: torch.Tensor, e: int, dtype=torch.int64) -> torch.Tensor:
    """``F.one_hot`` without its range check, which syncs with the card."""
    out = torch.zeros(idx.shape + (e,), dtype=dtype, device=idx.device)
    return out.scatter_(-1, idx[..., None], 1)


def ranks_in_expert(eid: torch.Tensor, e: int) -> torch.Tensor:
    """Rank of each assignment within its expert: an exclusive cumsum of the
    one-hot of ``eid`` (token-major order)."""
    oh = one_hot(eid, e)
    return (oh.cumsum(0) - oh).gather(1, eid[:, None])[:, 0]


class MoE(nn.Module):
    """Routed experts (stacked (E, d, f) weights, E padded to a tp
    multiple) plus an optional shared swiglu expert of n_shared * d_ff,
    routed as ``spec`` says (its ``n_experts`` are the real ones)."""

    def __init__(self, d_model: int, spec: MoESpec, generator, tp: int = 1,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.spec = spec
        e, f = padded_experts(spec.n_experts, tp), spec.d_ff
        s_in, s_out = d_model ** -0.5, f ** -0.5
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.router = normal_param((e, d_model), s_in, **kw)
        self.w_gate = normal_param((e, d_model, f), s_in, **kw)
        self.w_up = normal_param((e, d_model, f), s_in, **kw)
        self.w_down = normal_param((e, f, d_model), s_out, **kw)
        self.shared = (MLP(d_model, spec.n_shared * f, "swiglu", **kw)
                       if spec.n_shared > 0 else None)

    @property
    def n_experts(self) -> int:
        """Experts in the buffers, padding included."""
        return self.router.shape[0]

    def dispatch(self, flat: torch.Tensor, router_kind: str,
                 n_real: int | None) -> Dispatch:
        """Route n tokens (n, d): probabilities, the top k, ranks, drops."""
        sp = self.spec
        n, e = flat.shape[0], self.n_experts
        cap = capacity(n, sp.top_k, e, sp.capacity_factor, n_real)
        logits = F.linear(flat, self.router).float()
        probs = route(logits, router_kind, n_iter=sp.router_iters,
                      n_real=n_real)                              # (n, E)
        topw, topi = top_k_stable(probs, sp.top_k)                # (n, k)
        topw = topw / topw.sum(-1, keepdim=True).clamp(min=1e-9)
        rank = ranks_in_expert(topi.reshape(-1), e)
        keep = (rank < cap).to(flat.dtype)
        return Dispatch(probs, topw, topi, rank, keep, cap)

    def forward(self, x: torch.Tensor):
        """x (B, T, d) -> (out (B, T, d), aux load-balance loss scalar);
        the reference's ``moe_apply`` with ``n_real`` the spec's expert
        count."""
        b, t, d = x.shape
        n, e, k = b * t, self.n_experts, self.spec.top_k
        flat = x.reshape(n, d)
        dp = self.dispatch(flat, self.spec.router, self.spec.n_experts)
        eid = dp.topi.reshape(-1)
        rankc = dp.rank.clamp(max=dp.cap - 1)
        tok = torch.arange(n, device=x.device).repeat_interleave(k)
        # dropped assignments add exactly 0.0 into slot cap - 1
        buf = torch.zeros((e, dp.cap, d), dtype=x.dtype, device=x.device)
        buf.index_put_((eid, rankc), flat[tok] * dp.keep[:, None],
                       accumulate=True)                           # (E, C, d)
        h = torch.bmm(buf, self.w_gate)
        hu = torch.bmm(buf, self.w_up)
        out_buf = torch.bmm(F.silu(h) * hu, self.w_down)
        gathered = out_buf[eid, rankc] \
            * (dp.keep * dp.topw.reshape(-1).to(x.dtype))[:, None]
        out = gathered.reshape(n, k, d).sum(1)
        if self.shared is not None:
            out = out + self.shared(flat)
        # switch-style aux loss: E * sum_e fraction_tokens_e * mean_prob_e
        frac = one_hot(dp.topi[:, 0], e, torch.float32).mean(0)
        aux = e * (frac * dp.probs.mean(0)).sum()
        return out.reshape(b, t, d), aux.to(x.dtype)


def moe_dropped_fraction(moe: MoE, x: torch.Tensor,
                         router_kind: str) -> torch.Tensor:
    """Fraction of (token, expert) assignments dropped at capacity: the
    router-quality metric the Sinkhorn router improves. As the reference's,
    it routes over every expert in the buffers, with no ``n_real``."""
    dp = moe.dispatch(x.reshape(-1, x.shape[-1]), router_kind, None)
    return (dp.rank >= dp.cap).float().mean()
