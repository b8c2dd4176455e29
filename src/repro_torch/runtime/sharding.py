"""Meshes, the counted collectives of the sharded engine, the distributed
solver and expert parallelism, and the LM sharding rules (port of
``repro.runtime.sharding``).

The port keeps the reference's single-controller model: one process
drives every shard, one pool thread per shard, and each of the
reference's ``shard_map`` collectives becomes a host-driven copy between
per-position tensors. There is no ``torch.distributed``: NCCL refuses two
ranks on one card, and a multi-process server would be a design the
reference lacks.

``CorpusMesh``
    The devices of a mesh with its axis names and shape. Positions may
    repeat a device: on one card every position sits on ``cuda:0``, and
    on the host every position on ``"cpu"``. That is also what the
    reference's ``ensure_host_devices`` is for (it forces N host devices
    through an XLA flag): here a mesh of N positions over fewer devices
    makes N shards available, with nothing to set before start-up.
``corpus_mesh``
    A 1-D mesh of shard positions, round-robin over the visible CUDA
    devices unless the caller names the devices.
``all_gather``, ``psum``, ``psum_scatter``, ``pmax``
    The collectives, over a list of per-position tensors in the mesh's
    row-major position order. Each moves its operands to the target
    device (or devices), reduces in position order (so the result does not
    depend on the placement) and adds one to its counter.
``count_collectives``
    Runs a function and returns ``{name: calls}`` of the collectives it
    made: the port's check that a merge runs exactly one ``all_gather``
    and a fixed distributed loop none (the reference walks a jaxpr).
    ``collective_bytes`` reads the payload bytes recorded beside the
    counts.
The LM rules (``RULES``, ``param_spec_for``, ``param_specs``,
``opt_state_specs``, ``batch_spec``, ``activation_spec``, ``cache_specs``)
    One table of specs over the reference's parameter paths ('a/b/c') and
    its stacked layout (per-layer leaves on leading layer dims, matrices
    in (in, out) layout): the port's parameters map onto that layout
    through ``models.convert.reference_leaf``. A spec is a tuple with one
    entry per dim: ``None`` (replicated), an axis name, or a tuple of
    axis names. Axis sizes come from the ``mesh`` argument; the
    reference's ``_AXIS_SIZES`` global and ``set_axis_sizes`` have no
    counterpart. In place of the reference's ``shardings``,
    ``shard_shape`` gives what one position holds of a sharded tensor and
    ``shard_tensor`` slices it out for one position's coordinates.
"""
from __future__ import annotations

import itertools
import math
import re
import threading
from typing import NamedTuple

import torch

from repro_torch.optim.adamw import AdamWState


class CorpusMesh(NamedTuple):
    """Mesh positions: ``devices`` in row-major order over ``shape``, named
    by ``axis_names``. A device may stand at several positions."""

    devices: tuple           # torch.device per position
    axis_names: tuple
    shape: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def coords(self):
        """The positions' coordinates, in position order."""
        return list(itertools.product(*(range(n) for n in self.shape)))

    def describe(self) -> dict:
        return {"shape": list(self.shape), "axis_names": list(self.axis_names),
                "devices": [str(d) for d in self.devices]}


def make_mesh(shape, axis_names, devices=None) -> CorpusMesh:
    """A mesh of ``prod(shape)`` positions. ``devices`` lists one device
    per position (repeats allowed) or fewer, dealt round-robin; ``None``
    deals the visible CUDA devices and raises when there is none (the CPU
    is used only when the caller names it)."""
    shape = tuple(int(n) for n in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names) or min(shape, default=0) < 1:
        raise ValueError(f"mesh shape {shape} does not fit axis names "
                         f"{axis_names}")
    n = 1
    for s in shape:
        n *= s
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a corpus mesh places its positions on CUDA devices by "
                "default and none is available; pass devices=['cpu'] to "
                "place them on the host")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return CorpusMesh(tuple(devices[i % len(devices)] for i in range(n)),
                      axis_names, shape)


def corpus_mesh(n_shards: int, devices=None) -> CorpusMesh:
    """1-D mesh over the doc-shard axis ``"shard"`` for
    :class:`~repro_torch.core.shard_index.ShardedCorpusIndex`: shard s on
    ``devices[s % len(devices)]`` (default: the visible CUDA devices)."""
    if int(n_shards) < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return make_mesh((int(n_shards),), ("shard",), devices)


# ------------------------------------------------------------ collectives
COLLECTIVES = ("all_gather", "psum", "psum_scatter", "pmax")
_counts = dict.fromkeys(COLLECTIVES, 0)
_bytes = dict.fromkeys(COLLECTIVES, 0)
_lock = threading.Lock()


def _count(name: str, parts) -> None:
    """One call of ``name``; its payload is every position's operand."""
    n = sum(t.numel() * t.element_size() for t in parts)
    with _lock:
        _counts[name] += 1
        _bytes[name] += n


def collective_counts() -> dict:
    with _lock:
        return dict(_counts)


def collective_bytes() -> dict:
    """``{name: bytes}`` moved by each collective so far: the operands of
    every position taking part, summed (divide by the positions for the
    per-position payload the reference's HLO accounting reports)."""
    with _lock:
        return dict(_bytes)


def count_collectives(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` and return ``{name: calls}`` of the
    collectives made meanwhile (names with no call left out). Counts are
    process-wide: collectives that other threads make in that time are
    counted too.

    ``repro_torch.core`` re-exports it under the reference's name, with
    the port's signature: the reference's ``count_collectives`` walks a
    jaxpr without running it; this one runs ``fn`` and counts the
    host-driven collectives it makes."""
    before = collective_counts()
    fn(*args, **kwargs)
    after = collective_counts()
    return {k: after[k] - before[k] for k in COLLECTIVES
            if after[k] != before[k]}


def _groups(mesh: CorpusMesh, axes) -> list:
    """Position indices grouped by their coordinates off ``axes``; each
    group in position order (the order along ``axes``)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    on = [mesh.axis_names.index(a) for a in axes]
    groups: dict = {}
    for p, c in enumerate(mesh.coords()):
        key = tuple(v for i, v in enumerate(c) if i not in on)
        groups.setdefault(key, []).append(p)
    return list(groups.values())


def _sum(parts, dev) -> torch.Tensor:
    out = parts[0].to(dev)
    for t in parts[1:]:
        out = out + t.to(dev)
    return out


def all_gather(parts, dst) -> torch.Tensor:
    """Stack every position's tensor on ``dst``: (P, ...). The merge's one
    collective."""
    _count("all_gather", parts)
    dst = torch.device(dst)
    return torch.stack([t.to(dst) for t in parts])


def psum(mesh: CorpusMesh, parts, axes) -> list:
    """Sum over ``axes``: every position gets its group's sum, on its own
    device."""
    _count("psum", parts)
    out = list(parts)
    for g in _groups(mesh, axes):
        total = _sum([parts[p] for p in g], parts[g[0]].device)
        for p in g:
            out[p] = total.to(parts[p].device)
    return out


def pmax(mesh: CorpusMesh, parts, axes) -> list:
    """Elementwise max over ``axes``, each position getting its group's."""
    _count("pmax", parts)
    out = list(parts)
    for g in _groups(mesh, axes):
        dev = parts[g[0]].device
        top = parts[g[0]]
        for p in g[1:]:
            top = torch.maximum(top, parts[p].to(dev))
        for p in g:
            out[p] = top.to(parts[p].device)
    return out


def psum_scatter(mesh: CorpusMesh, parts, axes, dim: int) -> list:
    """Sum over ``axes``, then deal the sum's ``dim`` in equal tiles along
    the group: the i-th position of a group gets tile i (the reference's
    tiled ``psum_scatter``)."""
    _count("psum_scatter", parts)
    out = list(parts)
    for g in _groups(mesh, axes):
        total = _sum([parts[p] for p in g], parts[g[0]].device)
        if total.shape[dim] % len(g):
            raise ValueError(f"psum_scatter: dim {dim} of size "
                             f"{total.shape[dim]} does not split over "
                             f"{len(g)} positions")
        for tile, p in zip(torch.chunk(total, len(g), dim=dim), g):
            out[p] = tile.to(parts[p].device)
    return out


# ------------------------------------------------------------- LM rules
# (regex over the reference's 'a/b/c' parameter path, spec of the LAST
# dims); leading stacked layer / group dims are replicated (None-padded on
# the left). Megatron-style TP over "model"; experts over "model" (EP).
RULES: list = [
    (r"embed$",                    ("model", None)),
    (r"lm_head$",                  (None, "model")),
    # attention
    (r"attn/w[qkv]$",              (None, "model")),
    (r"attn/wo$",                  ("model", None)),
    (r"attn/b[qkv]$",              ("model",)),
    # dense mlp / shared expert / rwkv channel-mix
    (r"(mlp|cmix|shared)/w_(gate|up|in)$", (None, "model")),
    (r"(mlp|cmix|shared)/w_(down|out)$",   ("model", None)),
    # moe: experts over model (EP); router replicated
    (r"moe/router$",               (None, None)),
    (r"moe/w_(gate|up)$",          ("model", None, None)),
    (r"moe/w_down$",               ("model", None, None)),
    # mamba2: heads / d_inner over model; B and C small, replicated
    (r"mamba/w_(z|x)$",            (None, "model")),
    (r"mamba/w_bc$",               (None, None)),
    (r"mamba/w_dt$",               (None, "model")),
    (r"mamba/conv_x$",             (None, "model")),
    (r"mamba/conv_bias_x$",        ("model",)),
    (r"mamba/(conv_bc|conv_bias_bc)$", (None,)),
    (r"mamba/(a_log|d_skip|dt_bias)$", ("model",)),
    (r"mamba/norm_scale$",         ("model",)),
    (r"mamba/out_proj$",           ("model", None)),
    # rwkv6 time-mix
    (r"tmix/w[rkvg]$",             (None, "model")),
    (r"tmix/wo$",                  ("model", None)),
    (r"tmix/w0$",                  ("model",)),
    (r"tmix/w1$",                  (None, None)),
    (r"tmix/w2$",                  (None, "model")),
    (r"tmix/u$",                   ("model", None)),
    (r"tmix/ln_scale$",            ("model",)),
    (r"tmix/mu$",                  (None, None)),
    # norms and everything small
    (r".*",                        ()),
]

FSDP_MIN_ELEMENTS = 1 << 20


def param_spec_for(path: str, ndim: int) -> tuple:
    """The first rule matching ``path``, its spec padded on the left with
    ``None`` to ``ndim`` entries."""
    for pat, spec in RULES:
        if re.search(pat, path):
            spec = tuple(spec)
            if len(spec) > ndim:
                spec = spec[-ndim:] if ndim else ()
            return (None,) * (ndim - len(spec)) + spec
    return (None,) * ndim


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _n(mesh: CorpusMesh, entry) -> int:
    n = 1
    for a in _axes(entry):
        n *= mesh.axis_size(a)
    return n


def data_axes(mesh: CorpusMesh, tp_axis: str = "model") -> tuple:
    """Every axis but the tensor-parallel one, in mesh order."""
    return tuple(a for a in mesh.axis_names if a != tp_axis)


def _entry(axes: tuple):
    """A spec entry over ``axes``: ``None``, one name, or a tuple."""
    axes = tuple(axes)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def param_specs(shapes: dict, mesh: CorpusMesh,
                fsdp_axes: tuple = ()) -> dict:
    """``{reference path: spec}`` over ``shapes``, ``{reference path:
    shape}`` of a model's stacked parameters
    (``models.convert.reference_shapes``), as the reference's takes its
    params pytree.

    ``fsdp_axes`` (``("data",)`` or ``("pod", "data")``) additionally
    shards every leaf of at least 2^20 elements over those axes on its
    last still-unsharded dim that their size divides (ZeRO-3 / FSDP; the
    search runs from the last dim so that a layer stack is not split)."""
    fsdp_axes = tuple(fsdp_axes)
    need = _n(mesh, fsdp_axes)
    out = {}
    for path, shape in shapes.items():
        spec = param_spec_for(path, len(shape))
        if fsdp_axes and math.prod(shape) >= FSDP_MIN_ELEMENTS:
            for i in reversed(range(len(spec))):
                if spec[i] is None and shape[i] % need == 0 \
                        and shape[i] >= need:
                    spec = spec[:i] + (_entry(fsdp_axes),) + spec[i + 1:]
                    break
        out[path] = spec
    return out


def opt_state_specs(specs: dict, zero1: bool = False):
    """AdamW state specs: ``step`` replicated, ``m`` and ``v`` mirroring
    the parameters' ``specs``. ``zero1=True`` shards every moment whose
    first dim is replicated over ``"data"`` (ZeRO-1)."""

    def z1(spec: tuple) -> tuple:
        if zero1 and spec and spec[0] is None:
            return ("data",) + tuple(spec[1:])
        return spec

    mv = {k: z1(s) for k, s in specs.items()}
    return AdamWState(step=(), m=mv, v=dict(mv))


def batch_spec(mesh: CorpusMesh) -> tuple:
    """(B, T) token batches: the batch over every data-ish axis."""
    return (_entry(data_axes(mesh)),)


def activation_spec(mesh: CorpusMesh) -> tuple:
    return (_entry(data_axes(mesh)), None, None)


def cache_specs(cache: dict, mesh: CorpusMesh,
                seq_shard: bool = False) -> dict:
    """Serve-cache specs by cache key (``pos``, a host int, replicated).
    KV caches (L, B, H_kv, S, D): batch over the data axes, heads over
    model; ``seq_shard=True`` (long-context decode at batch 1) shards the
    sequence dim over the data axes instead. SSM states: batch over data
    (unless ``seq_shard``), heads over model; conv windows and token
    shifts: batch over data."""
    dax = _entry(data_axes(mesh))
    out = {}
    for name, x in cache.items():
        nd = getattr(x, "ndim", 0)
        s = [None] * nd
        if name in ("k", "v"):
            if seq_shard:
                s[-2] = dax
            else:
                s[-4] = dax
            s[-3] = "model"
        elif name in ("wkv", "ssm", "ssm_rem"):
            s[-4] = None if seq_shard else dax
            s[-3] = "model"
        elif name in ("conv", "conv_rem", "shift"):
            s[-3] = None if seq_shard else dax
        out[name] = tuple(s)
    return out


def shard_shape(shape, spec: tuple, mesh: CorpusMesh) -> tuple:
    """What one position holds of a tensor of ``shape`` under ``spec``:
    each sharded dim divided by its axes' size, rounded up (an uneven
    last shard is padded to it)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-int(n) // _n(mesh, e)) for n, e in zip(shape, spec))


def shard_index(spec: tuple, mesh: CorpusMesh, coords) -> tuple:
    """Per dim, the shard that the position at ``coords`` holds (its
    row-major index over the dim's axes)."""
    idx = []
    for e in spec:
        i = 0
        for a in _axes(e):
            j = mesh.axis_names.index(a)
            i = i * mesh.shape[j] + coords[j]
        idx.append(i)
    return tuple(idx)


def shard_tensor(t: torch.Tensor, spec: tuple, mesh: CorpusMesh,
                 coords) -> torch.Tensor:
    """The slice of ``t`` that the position at ``coords`` holds under
    ``spec`` (a view; the last shard of an uneven dim is short)."""
    spec = tuple(spec) + (None,) * (t.ndim - len(spec))
    size = shard_shape(t.shape, spec, mesh)
    for dim, (i, n) in enumerate(zip(shard_index(spec, mesh, coords), size)):
        if n != t.shape[dim]:
            t = t.narrow(dim, min(i * n, t.shape[dim]),
                         max(0, min(n, t.shape[dim] - i * n)))
    return t


def spec_bytes(shapes: dict, specs: dict, mesh: CorpusMesh,
               itemsize: int) -> int:
    """Bytes one position holds of the tensors ``shapes`` (name -> shape)
    under ``specs`` (name -> spec), ``itemsize`` bytes an element."""
    return sum(math.prod(shard_shape(shapes[k], specs[k], mesh)) * itemsize
               for k in shapes)
