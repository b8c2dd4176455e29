"""Mixture-of-Experts layer of the port: shared + routed experts, top-k
dispatch with capacity, expert parallelism over a mesh's ``model`` axis
(port of ``repro.models.moe``).

Router options: ``topk`` (softmax) or ``sinkhorn``, the paper's
Sinkhorn-Knopp solver as a balanced-assignment router
(``repro_torch.core.router``).

Dispatch is scatter-based, as the reference's: tokens are scattered into
an (E, C, d) capacity buffer by (expert, rank within expert), the experts
run as one ``torch.bmm`` per projection over stacked (E, d, f) weights,
and the results gather back. Assignments past capacity are dropped. Every
expert runs on its whole buffer, so a step reads every expert's weights
whatever the routing.

:func:`moe_apply_ep` is the expert-parallel layer over a
:class:`~repro_torch.runtime.sharding.CorpusMesh` of (data..., model)
positions, the reference's ``shard_map`` body run once per position by
the host: each position routes its data shard's tokens, runs its E/tp
experts and the shared expert's ff slice, and one counted ``psum`` over
``model`` combines the partial outputs.

A position on another device than the weights gets its slices (the routed
experts', the shared expert's ff slice, the router weight) through
:meth:`MoE.held`: with grad off, copied there once and held until the
source changes; in grad mode, moved on every call.
"""
from __future__ import annotations

import weakref
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MoESpec
from repro_torch.core.router import route
from repro_torch.runtime.sharding import (CorpusMesh, data_axes, psum,
                                          shard_index)
from .layers import MLP, normal_param


_SLICE_COPIES = [0]


def slice_copies() -> int:
    """Weight slices copied to another device by :func:`_to` so far."""
    return _SLICE_COPIES[0]


def _moves(w: torch.Tensor, dev: torch.device) -> bool:
    """Whether ``w`` must be copied to reach ``dev``."""
    return w.device != dev


def _to(w: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``w`` on ``dev``: itself where it lies there, else a copy (counted
    by :func:`slice_copies`). The one place an MoE slice moves."""
    if not _moves(w, dev):
        return w
    _SLICE_COPIES[0] += 1
    return w.to(dev, copy=True)


def padded_experts(n_experts: int, tp: int) -> int:
    """Experts shard over the model axis: the count is padded up to a tp
    multiple (qwen2-moe: 60 -> 64 at TP=16). Padded experts are
    router-masked and carry zero Sinkhorn column marginal, so they never
    receive tokens."""
    return -(-n_experts // tp) * tp


class Dispatch(NamedTuple):
    """One layer's routing of n tokens per leading index (...): ``probs``
    (..., n, E), ``topw`` and ``topi`` (..., n, k), and per assignment in
    token-major order (..., n * k): ``rank`` within its expert and
    ``keep`` (1 kept, 0 dropped)."""
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
    one-hot of ``eid`` (..., n * k) over its last dim (token-major
    order)."""
    oh = one_hot(eid, e)
    return (oh.cumsum(-2) - oh).gather(-1, eid[..., None])[..., 0]


def switch_aux(dp: Dispatch) -> torch.Tensor:
    """Switch-style load-balance loss per leading index, fp32:
    E * sum_e fraction_tokens_e * mean_prob_e."""
    e = dp.probs.shape[-1]
    frac = one_hot(dp.topi[..., 0], e, torch.float32).mean(-2)
    return e * (frac * dp.probs.mean(-2)).sum(-1)


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
        self._held: dict = {}
        self.register_load_state_dict_post_hook(
            lambda mod, _: mod._held.clear())

    def held(self, w: torch.Tensor, sel, dev: torch.device,
             key: tuple) -> torch.Tensor:
        """``w[sel]`` on ``dev`` (:func:`_to`). On the weights' own device
        it is a view, and with grad on a copy made on every call, so
        gradients flow back through it; neither is held. With grad off, a
        copy to another device is held per (``dev``, ``key``), ``key``
        naming the slice as (name, model index, tp), and reused while
        ``w`` is the same tensor at the same version and storage: an
        in-place update (AdamW), a reassigned parameter, a move of the
        module or a ``load_state_dict`` makes a fresh one at the next
        call. A device holds one tp's slices: a key of another tp drops
        the device's others. Only a weak reference to ``w`` is kept. An
        inference tensor (a model built under ``torch.inference_mode()``,
        as the server builds it) tracks no version, and neither does a
        write through ``.data``: the caller must not write such weights in
        place other than by ``load_state_dict``."""
        if torch.is_grad_enabled() or not _moves(w, dev):
            return _to(w[sel], dev)
        stamp = (None if w.is_inference() else w._version, w.data_ptr())
        hit = self._held.get((dev, key))
        if hit is None or hit[0]() is not w or hit[1] != stamp:
            for old in [k for k in self._held
                        if k[0] == dev and k[1][-1] != key[-1]]:
                del self._held[old]
            hit = self._held[dev, key] = (weakref.ref(w), stamp,
                                          _to(w[sel], dev))
        return hit[2]

    @property
    def n_experts(self) -> int:
        """Experts in the buffers, padding included."""
        return self.router.shape[0]

    def dispatch(self, xs: torch.Tensor, router_kind: str,
                 n_real: int | None, tp: int = 1) -> Dispatch:
        """Route n tokens xs (..., n, d), each leading index on its own:
        probabilities, the top k, ranks, drops, and the capacity of n;
        ``tp`` is the mesh's model axis, which keys the held router."""
        sp = self.spec
        n, e = xs.shape[-2], self.n_experts
        cap = capacity(n, sp.top_k, e, sp.capacity_factor, n_real)
        logits = F.linear(xs, self.held(self.router, slice(None),
                                        xs.device, ("router", 0, tp))
                          ).float()
        probs = route(logits, router_kind, n_iter=sp.router_iters,
                      n_real=n_real)                          # (..., n, E)
        topw, topi = top_k_stable(probs, sp.top_k)            # (..., n, k)
        topw = topw / topw.sum(-1, keepdim=True).clamp(min=1e-9)
        rank = ranks_in_expert(topi.flatten(-2), e)
        keep = (rank < cap).to(xs.dtype)
        return Dispatch(probs, topw, topi, rank, keep, cap)

    def experts(self, xs: torch.Tensor, dp: Dispatch, ms=(0,),
                tp: int = 1) -> torch.Tensor:
        """xs (G, n, d), routed by ``dp`` -> (G, n, d): the layer's body
        without its aux. Row g's tokens scatter into its (E, C, d) buffer,
        run through the E/tp experts of model index ``ms[g]`` (all of them
        at tp 1) and gather back; the shared expert runs on that index's
        slice of its ff dim. At tp > 1 each row is so a partial sum over
        the model axis. ``ms`` is sorted, so an index's rows are one slice
        and its experts one ``bmm`` per projection over their buffers.
        The weights are slices of the stacked ones on xs's device
        (:meth:`held`): views on their own device, a copy on any other,
        held across calls with grad off."""
        g, n, d = xs.shape
        k, dev = self.spec.top_k, xs.device
        e_loc = self.n_experts // tp
        eid = dp.topi.reshape(g, n * k)
        rankc = dp.rank.clamp(max=dp.cap - 1)
        tok = torch.arange(n, device=dev).repeat_interleave(k)
        gi = torch.arange(g, device=dev)[:, None].expand(g, n * k)
        # dropped assignments add exactly 0.0 into slot cap - 1
        buf = torch.zeros((g, self.n_experts, dp.cap, d), dtype=xs.dtype,
                          device=dev)
        buf.index_put_((gi, eid, rankc), xs[:, tok] * dp.keep[..., None],
                       accumulate=True)                       # (G, E, C, d)
        wt = (dp.keep * dp.topw.reshape(g, n * k).to(xs.dtype))[..., None]
        outs = []
        for m in sorted(set(ms)):
            lo, hi = ms.index(m), len(ms) - ms[::-1].index(m)
            ex = slice(m * e_loc, (m + 1) * e_loc)
            my = buf[lo:hi, ex].transpose(0, 1).reshape(
                e_loc, (hi - lo) * dp.cap, d)
            wg, wu, wd = (self.held(getattr(self, nm), ex, dev,
                                    (nm, m, tp))
                          for nm in ("w_gate", "w_up", "w_down"))
            h = torch.bmm(my, wg)
            hu = torch.bmm(my, wu)
            ob = torch.bmm(F.silu(h) * hu, wd) \
                .reshape(e_loc, hi - lo, dp.cap, d).transpose(0, 1)
            if tp > 1:                  # another index's experts add 0
                rel = eid[lo:hi] - m * e_loc
                got = ob[gi[:hi - lo], rel.clamp(0, e_loc - 1),
                         rankc[lo:hi]]
                got = torch.where(((rel >= 0) & (rel < e_loc))[..., None],
                                  got, got.new_zeros(()))
            else:
                got = ob[gi, eid, rankc]
            out = (got * wt[lo:hi]).reshape(hi - lo, n, k, d).sum(2)
            sh = self.shared
            if sh is not None:
                f_loc = sh.w_gate.shape[0] // tp
                fs = slice(m * f_loc, (m + 1) * f_loc)
                sg = self.held(sh.w_gate, fs, dev, ("shared.w_gate", m, tp))
                su = self.held(sh.w_up, fs, dev, ("shared.w_up", m, tp))
                sd = self.held(sh.w_down, (slice(None), fs), dev,
                               ("shared.w_down", m, tp))
                x = xs[lo:hi]
                out = out + F.linear(F.silu(F.linear(x, sg))
                                     * F.linear(x, su), sd)
            outs.append(out)
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def forward(self, x: torch.Tensor):
        """x (B, T, d) -> (out (B, T, d), aux load-balance loss scalar);
        the reference's ``moe_apply`` with ``n_real`` the spec's expert
        count."""
        b, t, d = x.shape
        xs = x.reshape(1, b * t, d)
        dp = self.dispatch(xs, self.spec.router, self.spec.n_experts)
        out = self.experts(xs, dp)
        return out.reshape(b, t, d), switch_aux(dp)[0].to(x.dtype)


def moe_apply_ep(moe: MoE, x: torch.Tensor, mesh: CorpusMesh,
                 tp_axis: str = "model"):
    """x (B, T, d) -> (out (B, T, d), aux): :class:`MoE` with its experts
    dealt over ``mesh``'s ``tp_axis`` (the reference's ``moe_apply_ep``).

    The B * T tokens split into equal contiguous shards over the other
    axes (the data axes; the reference's batch split where their size
    divides B). Per position, on its device, :meth:`MoE.dispatch` routes
    and ranks its data shard's n_loc tokens locally, with the capacity
    ``int(cf * k * n_loc / n_real + 1)`` (so the Sinkhorn router balances
    per data shard; top-k routing equals the single-device layer's), and
    :meth:`MoE.experts` runs its E/tp experts and its slice of the shared
    expert's ff dim. The positions that share a device run as one batch
    of rows, each with its own routing, which computes what a loop over
    them would.

    One counted ``psum`` over ``tp_axis`` sums the partial outputs, and
    each data shard's sum comes back to x's device. ``aux`` is the mean
    over the data shards of each shard's switch loss (the reference's
    ``lax.pmean``; equal over ``tp_axis`` already). Gradients flow
    through the host-driven copies by autograd.

    Where a position lies on another device than the weights, its expert
    slice, shared ff slice and the router weight are copied there by
    :meth:`MoE.held`. With grad off (serving, ``torch.inference_mode()``)
    each device holds each slice once, from the first call that places
    it there until its source changes, so later steps move no weights.
    In grad mode (training) the copies are made on every call of every
    layer, so that autograd carries each one's gradient back to the
    stacked weights: EP training over several cards still moves the
    routed weights each step."""
    b, t, d = x.shape
    tp = mesh.axis_size(tp_axis)
    if moe.n_experts % tp:
        raise ValueError(f"{moe.n_experts} experts do not split over "
                         f"{tp_axis}={tp}")
    n_data = mesh.size // tp
    n = b * t
    if n % n_data:
        raise ValueError(f"{n} tokens do not split over {n_data} data "
                         "shards")
    shared = moe.shared
    if shared is not None and shared.w_gate.shape[0] % tp:
        raise ValueError(f"shared ff {shared.w_gate.shape[0]} does not "
                         f"split over {tp_axis}={tp}")
    ti = mesh.axis_names.index(tp_axis)
    coords = mesh.coords()
    dax = data_axes(mesh, tp_axis)
    shards = [shard_index((dax,), mesh, c)[0] for c in coords]
    xs_all = x.reshape(n_data, n // n_data, d)
    parts, auxs = [None] * mesh.size, {}
    groups: dict = {}
    for pos, dev in enumerate(mesh.devices):
        groups.setdefault(dev, []).append(pos)
    for dev, poss in groups.items():
        # by model index, so each index's positions are one slice
        poss = sorted(poss, key=lambda p: (coords[p][ti], p))
        ms = [coords[p][ti] for p in poss]
        xd = xs_all.to(dev)
        xs = torch.cat([xd[shards[p]:shards[p] + 1] for p in poss])
        dp = moe.dispatch(xs, moe.spec.router, moe.spec.n_experts, tp)
        out = moe.experts(xs, dp, ms, tp)                   # (G, n_loc, d)
        aux = switch_aux(dp)                                # (G,)
        for i, p in enumerate(poss):
            parts[p] = out[i]
            if ms[i] == 0:
                auxs[shards[p]] = aux[i]
    parts = psum(mesh, parts, tp_axis)      # ONE collective per MoE layer
    first = {}
    for pos, shard in enumerate(shards):
        first.setdefault(shard, pos)
    out = torch.cat([parts[first[s]].to(x.device) for s in range(n_data)])
    aux = torch.stack([auxs[s].to(x.device) for s in range(n_data)]).mean()
    return out.reshape(b, t, d), aux.to(x.dtype)


def moe_dropped_fraction(moe: MoE, x: torch.Tensor,
                         router_kind: str) -> torch.Tensor:
    """Fraction of (token, expert) assignments dropped at capacity: the
    router-quality metric the Sinkhorn router improves. As the reference's,
    it routes over every expert in the buffers, with no ``n_real``."""
    dp = moe.dispatch(x.reshape(-1, x.shape[-1]), router_kind, None)
    return (dp.rank >= dp.cap).float().mean()
