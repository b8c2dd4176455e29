"""Roofline accounting of the port (port of ``repro.runtime.analysis``).

``torch_cost(fn, *args, **kwargs)``
    Runs ``fn`` under a ``TorchDispatchMode`` and counts what reaches the
    aten ops (the backward included, when ``fn`` calls it; a recompute
    under ``torch.utils.checkpoint`` counted where it runs), the
    counterpart of the reference's ``jaxpr_cost``:

    * FLOPs: 2 * M * N * K for ``mm``, ``bmm``, ``addmm``, ``baddbmm``
      and 2 * (output elements) * (input channels a group * kernel
      elements) for ``convolution``; one FLOP for every output element of
      any other op but views (an op whose output aliases its input moves
      and computes nothing);
    * major bytes: operands and results of the aten counterparts of the
      reference's major primitives (products, convolutions, gathers,
      scatters, cumsum, sort, top-k, slice updates), plus the program's
      inputs and outputs once: a lower bound of HBM traffic that assumes
      elementwise chains fused;
    * the port's counted collectives made meanwhile (calls and payload
      bytes, ``runtime.sharding.collective_bytes``): the expert-parallel
      MoE's ``psum`` on a mesh.

    Run it on ``meta`` tensors: shapes only, so a full-width cell costs
    no memory.
``stacked_cost(cfg, walk, remat)``
    A layer stack walked at a few small depths and extrapolated to the
    config's, as the reference's walker multiplies a scan body by its
    length: every layer of a stack runs the same ops, so a cost is linear
    in the counts of grouped layers, remainder layers and groups of the
    two-level remat schedule (for the hybrid: groups, their Mamba2 layers
    and the remainder), and four walks fix it.
``analytic_hbm_bytes``
    The reference's per-chip HBM traffic model, the same arithmetic.
``analytic_collective_bytes``
    The per-chip collective payload of one step, counted per layer (the
    reference parses XLA's HLO for it, which the port has no counterpart
    of); its terms are in its docstring.
``roofline_terms``
    The reference's roofline arithmetic over ``hw``: by default
    :data:`H100`, the H100 SXM5's datasheet values.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.runtime import sharding as SH

aten = torch.ops.aten

# datasheet values of an H100 SXM5 (dense bf16 tensor cores, HBM3, NVLink
# each way); the card measured in this repo reports itself as "NVIDIA H100
# 80GB HBM3, 700.00 W"
H100 = {
    "peak_flops_bf16": 989e12,     # FLOP/s
    "hbm_bw": 3.35e12,             # B/s
    "link_bw": 450e9,              # B/s of NVLink, each way
}

_MATMULS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm}
_MAJOR = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.convolution,
          aten.gather, aten.index, aten.index_select, aten.embedding,
          aten.take, aten.scatter, aten.scatter_add, aten.scatter_reduce,
          aten.index_put, aten.index_put_, aten.index_add,
          aten.index_copy, aten.cumsum, aten.sort, aten.topk,
          aten.slice_scatter, aten.select_scatter, aten.copy_}


def _tensors(tree) -> list:
    """Every tensor in ``tree``: pytree containers, dataclasses and a
    module's parameters and buffers."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return _tensors([getattr(tree, f.name)
                         for f in dataclasses.fields(tree)])
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    major_bytes: float = 0.0
    collective_calls: float = 0.0
    collective_bytes: float = 0.0
    by_op: dict = dataclasses.field(default_factory=lambda: defaultdict(float))

    def __add__(self, other: "Cost") -> "Cost":
        by = defaultdict(float, self.by_op)
        for k, v in other.by_op.items():
            by[k] += v
        return Cost(self.flops + other.flops,
                    self.major_bytes + other.major_bytes,
                    self.collective_calls + other.collective_calls,
                    self.collective_bytes + other.collective_bytes, by)

    def scaled(self, a: float) -> "Cost":
        return Cost(self.flops * a, self.major_bytes * a,
                    self.collective_calls * a, self.collective_bytes * a,
                    defaultdict(float, {k: v * a
                                        for k, v in self.by_op.items()}))

    def as_dict(self) -> dict:
        top = sorted(self.by_op.items(), key=lambda kv: -kv[1])[:8]
        return {"flops": float(self.flops),
                "major_bytes": float(self.major_bytes),
                "collective_calls": float(self.collective_calls),
                "collective_bytes": float(self.collective_bytes),
                "top_flops_ops": {k: float(v) for k, v in top}}


def _key(func, args, kwargs):
    """A hashable key of an op on meta tensors, or None where its result
    may depend on more than the shapes (an op that writes or aliases its
    inputs, an input off meta)."""
    if func.is_view or func._schema.is_mutable:
        return None
    parts = [func]
    for a in tree_flatten((args, kwargs))[0]:
        if isinstance(a, torch.Tensor):
            if a.device.type != "meta":
                return None
            parts.append((tuple(a.shape), a.stride(), a.dtype))
        elif isinstance(a, (int, float, bool, str, type(None), torch.dtype,
                            torch.device, torch.layout,
                            torch.memory_format)):
            parts.append(a)
        else:
            return None
    return tuple(parts)


class _Counter(TorchDispatchMode):
    """Counts every op; on ``meta`` it replays the output shapes of an op
    already seen with the same input shapes instead of running its meta
    kernel again (some are Python decompositions: a layer's ops repeat
    over its positions and blocks)."""

    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost
        self.memo = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = _key(func, args, kwargs)
        spec = self.memo.get(key) if key is not None else None
        if spec is not None:
            outs = [torch.empty_strided(sh, st, dtype=dt, device="meta")
                    for sh, st, dt in spec[1]]
            out = outs[0] if spec[0] else tuple(outs)
        else:
            out = func(*args, **kwargs)
            if func.is_view:
                return out
            outs = [t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)]
            if key is not None and (isinstance(out, torch.Tensor) or (
                    isinstance(out, tuple) and len(outs) == len(out))):
                self.memo[key] = (isinstance(out, torch.Tensor), [
                    (tuple(t.shape), t.stride(), t.dtype) for t in outs])
        packet = func.overloadpacket
        if packet in _MATMULS:
            a = args[1] if packet in (aten.addmm, aten.baddbmm) else args[0]
            f = 2 * outs[0].numel() * a.shape[-1]
        elif packet is aten.convolution:
            w = args[1]
            f = 2 * outs[0].numel() * w.shape[1] * math.prod(w.shape[2:])
        else:
            f = sum(t.numel() for t in outs)
        name = packet.__name__
        self.cost.flops += f
        self.cost.by_op[name] += f
        if packet in _MAJOR:
            ins = [t for t in tree_flatten((args, kwargs or {}))[0]
                   if isinstance(t, torch.Tensor)]
            self.cost.major_bytes += sum(map(_nbytes, ins)) \
                + sum(map(_nbytes, outs))
        return out


def torch_cost(fn, *args, **kwargs) -> Cost:
    """FLOPs, major bytes and counted collectives of ``fn(*args,
    **kwargs)`` (see the module docstring). The tensors of the arguments
    (a module's parameters and buffers, dataclass fields) and of the
    result count once as the program's inputs and outputs."""
    cost = Cost()
    calls, moved = (sum(d.values()) for d in (SH.collective_counts(),
                                              SH.collective_bytes()))
    with _Counter(cost):
        out = fn(*args, **kwargs)
    cost.collective_calls = sum(SH.collective_counts().values()) - calls
    cost.collective_bytes = sum(SH.collective_bytes().values()) - moved
    seen = {}
    for t in _tensors((args, kwargs)):
        seen[id(t)] = t
    cost.major_bytes += sum(map(_nbytes, seen.values()))
    cost.major_bytes += sum(map(_nbytes, _tensors(out)))
    return cost


# ---------------------------------------------------------- layer stacks
def _sqrt_factor(n: int) -> tuple[int, int, int]:
    g = max(1, int(n ** 0.5))
    while n // g == 0:
        g -= 1
    k = n // g
    return g, k, n - g * k


def depth_features(cfg, remat: bool) -> tuple:
    """What a walk's cost is linear in, for ``cfg``'s depth: (1, grouped
    layers, remainder layers, groups) of the two-level remat schedule;
    for the hybrid (1, groups (one shared block each), their Mamba2
    layers, remainder layers); without remat (1, layers), or for the
    hybrid (1, groups, Mamba2 layers)."""
    n = cfg.num_layers
    if cfg.family == "hybrid":
        g = n // cfg.attn_every
        rem = n - g * cfg.attn_every
        return (1, g, g * cfg.attn_every, rem) if remat else (1, g, n)
    if not remat:
        return (1, n)
    g, k, rem = _sqrt_factor(n)
    return (1, g * k, rem, g)


def walk_configs(cfg, remat: bool) -> list:
    """The small-depth variants of ``cfg`` whose features span
    :func:`depth_features`: depths 1, 2, 4, 5 (1, 2 without remat); for
    the hybrid (layers, attn_every) (1, 1), (2, 1), (2, 2), (3, 2)."""
    rep = dataclasses.replace
    if cfg.family == "hybrid":
        shapes = [(1, 1), (2, 1), (2, 2), (3, 2)][:4 if remat else 3]
        return [rep(cfg, num_layers=n, attn_every=a) for n, a in shapes]
    return [rep(cfg, num_layers=n) for n in ((1, 2, 4, 5) if remat
                                             else (1, 2))]


def stacked_cost(cfg, walk, remat: bool) -> Cost:
    """The cost of ``walk(cfg)`` at ``cfg``'s depth from ``walk`` at the
    depths of :func:`walk_configs` (``walk(small_cfg) -> Cost``): a linear
    solve for each metric and op over :func:`depth_features`."""
    small = walk_configs(cfg, remat)
    costs = [walk(c) for c in small]
    feats = np.array([depth_features(c, remat) for c in small], float)
    w = np.linalg.solve(feats.T, np.array(depth_features(cfg, remat),
                                          float))
    total = Cost()
    for wi, c in zip(w, costs):
        total = total + c.scaled(float(wi))
    return total


# ---------------------------------------------------- analytic HBM model
def analytic_hbm_bytes(cfg, kind: str, gb: int, seq: int, n_chips: int,
                       tp: int, dtype_bytes: int = 2,
                       act_io_per_block: int = 16) -> float:
    """Per-chip HBM traffic of one step (the roofline memory term), the
    reference's model: WEIGHTS are read in full by every data shard
    (P/tp a chip), ACTIVATIONS divide over the data shards.

      train:   weights (forward, remat re-forward, backward reads,
               gradient write) + AdamW fp32 state (m, v, p read and
               written) + act_io_per_block passes of (tokens_loc x d) per
               block, x3 for forward / re-forward / backward + the loss's
               fp32 logits slab (read and written, vocab sharded)
      prefill: weights once + activations once + logits
      decode:  weights once + the KV / state cache read and one slot
               written + small activations
    """
    p_chip = cfg.n_params() / tp * dtype_bytes
    d = cfg.d_model
    tok_loc = gb * seq / max(n_chips / tp, 1)
    layer_w = max(cfg.num_layers, 1)
    act = act_io_per_block * layer_w * tok_loc * d * dtype_bytes
    vp = -(-cfg.vocab_size // tp) * tp
    logits_io = 2 * tok_loc * (vp / tp) * 4

    if kind == "train":
        weights = p_chip * (3 + 1)
        opt = cfg.n_params() / tp * 4 * 6
        return weights + opt + 3 * act + logits_io
    if kind == "prefill":
        return p_chip + act + logits_io
    if cfg.family in ("ssm", "hybrid"):
        if cfg.family == "ssm":
            n_heads = -(-(d // cfg.ssm.head_dim) // tp) * tp
            state = (cfg.num_layers * gb * n_heads * cfg.ssm.head_dim ** 2
                     + cfg.num_layers * gb * 2 * d)
        else:
            d_in = cfg.ssm.expand * d
            n_heads = d_in // cfg.ssm.head_dim
            state = cfg.num_layers * gb * (
                n_heads * cfg.ssm.d_state * cfg.ssm.head_dim
                + (cfg.ssm.conv_width - 1) * (d_in + 2 * cfg.ssm.d_state))
            n_groups = cfg.num_layers // cfg.attn_every
            _, n_kv = cfg.tp_heads(tp)
            state += n_groups * gb * n_kv * seq * cfg.head_dim / tp * 2
        cache_io = 2 * state * dtype_bytes / max(n_chips / tp, 1)
    else:
        _, n_kv = cfg.tp_heads(tp)
        kv = cfg.num_layers * gb * n_kv * seq * cfg.head_dim * 2
        cache_io = kv * dtype_bytes / n_chips
    return p_chip + cache_io + 2 * gb * d * cfg.num_layers * dtype_bytes


# ------------------------------------------------ analytic collectives
def tp_allreduces_per_pass(cfg) -> int:
    """Tensor-parallel all-reduces of the (tokens, d) activations in one
    forward: two a block (attention or time-mix out, MLP / MoE /
    channel-mix out; the MoE's is its expert-parallel ``psum``), one a
    Mamba2 layer, two per application of the hybrid's shared block."""
    if cfg.family == "hybrid":
        return cfg.num_layers + 2 * (cfg.num_layers // cfg.attn_every)
    return 2 * cfg.num_layers


def analytic_collective_bytes(cfg, kind: str, gb: int, seq: int,
                              n_chips: int, tp: int, fsdp: bool,
                              dtype_bytes: int = 2) -> dict:
    """Per-chip collective payload of one step (each collective's
    operand, as the reference's HLO accounting sums them), by term:

      tp_activations  tensor-parallel all-reduces of (tokens_loc, d):
                      :func:`tp_allreduces_per_pass` a pass; passes: 1
                      (prefill, decode) or 4 (train: forward, two-level
                      remat's two re-forwards, backward); none at tp = 1
      vocab           the vocab-sharded head: train, the loss's max and
                      sum-exp per token (2 x tokens_loc x 4 bytes);
                      prefill and decode, the last position's logits
                      gathered (sequences_loc x V x 4)
      fsdp_gathers    with FSDP, every pass all-gathers the weights (P/tp
                      x dtype_bytes); train adds the gradients'
                      reduce-scatter (P/tp x 4)
      dp_gradients    train without FSDP: the fp32 gradients all-reduced
                      over the data axes once a step (P/tp x 4), when
                      there is more than one data shard
    """
    data = max(n_chips / tp, 1)
    seqs_loc = gb / data
    tok_loc = seqs_loc * (seq if kind in ("train", "prefill") else 1)
    passes = 4 if kind == "train" else 1
    d = cfg.d_model
    terms = {"tp_activations": 0.0, "vocab": 0.0, "fsdp_gathers": 0.0,
             "dp_gradients": 0.0}
    if tp > 1:
        terms["tp_activations"] = (passes * tp_allreduces_per_pass(cfg)
                                   * tok_loc * d * dtype_bytes)
        vp = -(-cfg.vocab_size // tp) * tp
        terms["vocab"] = (2 * tok_loc * 4 if kind == "train"
                          else seqs_loc * vp * 4)
    w_chip = cfg.n_params() / tp
    if fsdp:
        terms["fsdp_gathers"] = passes * w_chip * dtype_bytes + (
            w_chip * 4 if kind == "train" else 0.0)
    elif kind == "train" and data > 1:
        terms["dp_gradients"] = w_chip * 4
    return {"per_term_bytes": terms, "total_bytes": float(sum(terms.values()))}


# ------------------------------------------------------------- roofline
def roofline_terms(global_flops: float, global_major_bytes: float,
                   per_dev_collective_bytes: float, n_chips: int,
                   model_flops: float, hw: dict = H100) -> dict:
    """The reference's roofline arithmetic over ``hw`` (keys
    ``peak_flops_bf16``, ``hbm_bw``, ``link_bw``)."""
    compute_s = global_flops / n_chips / hw["peak_flops_bf16"]
    memory_s = global_major_bytes / n_chips / hw["hbm_bw"]
    coll_s = per_dev_collective_bytes / hw["link_bw"]
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", coll_s), key=lambda kv: kv[1])[0]
    step_s = max(compute_s, memory_s, coll_s)
    mfu = (model_flops / n_chips / hw["peak_flops_bf16"]) / step_s \
        if step_s > 0 else 0.0
    return {
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": coll_s, "dominant": dominant,
        "model_flops": model_flops,
        "useful_ratio": model_flops / global_flops if global_flops else 0.0,
        "roofline_mfu": mfu,
    }
