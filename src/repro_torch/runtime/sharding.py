"""Corpus meshes and the counted collectives of the sharded engine and the
distributed solver (port of the corpus part of
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

The LM parameter rules of the reference module are not ported yet.
"""
from __future__ import annotations

import itertools
import threading
from typing import NamedTuple

import torch


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
_lock = threading.Lock()


def _count(name: str) -> None:
    with _lock:
        _counts[name] += 1


def collective_counts() -> dict:
    with _lock:
        return dict(_counts)


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
    _count("all_gather")
    dst = torch.device(dst)
    return torch.stack([t.to(dst) for t in parts])


def psum(mesh: CorpusMesh, parts, axes) -> list:
    """Sum over ``axes``: every position gets its group's sum, on its own
    device."""
    _count("psum")
    out = list(parts)
    for g in _groups(mesh, axes):
        total = _sum([parts[p] for p in g], parts[g[0]].device)
        for p in g:
            out[p] = total.to(parts[p].device)
    return out


def pmax(mesh: CorpusMesh, parts, axes) -> list:
    """Elementwise max over ``axes``, each position getting its group's."""
    _count("pmax")
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
    _count("psum_scatter")
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
