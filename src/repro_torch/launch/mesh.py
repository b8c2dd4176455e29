"""Production meshes of the port (port of ``repro.launch.mesh``).

Functions, so that importing this module touches no device state.

Topology: H100 nodes of 8 GPUs joined all to all by NVLink. Tensor
parallelism stays inside a node (``model`` = 8); the data axis spans the
nodes of a 256-GPU pod, and the multi-pod mesh adds a leading ``pod``
axis, so only data-parallel gradient reductions cross pods. The
single-pod mesh is (data=32, model=8), the multi-pod one (pod=2, data=32,
model=8): the reference's 256 and 512 chips, laid out for 8-GPU nodes
where the reference's (data=16, model=16) fills a 16 x 16 TPU torus.

Positions are dealt over ``devices`` as ``runtime.sharding.make_mesh``
deals them: the visible CUDA devices by default (raising without one),
``["meta"]`` for the dry-run's shape-only walk, ``["cpu"]`` on the host.
The reference's ``TPU_XLA_FLAGS`` (XLA scheduler flags for TPU
collectives) have no counterpart: the port sets no compiler flag.
"""
from __future__ import annotations

from repro_torch.runtime.sharding import CorpusMesh, make_mesh

NODE_GPUS = 8
POD_GPUS = 256


def make_production_mesh(*, multi_pod: bool = False,
                         devices=None) -> CorpusMesh:
    """(data=32, model=8), or (pod=2, data=32, model=8) with
    ``multi_pod``."""
    data = POD_GPUS // NODE_GPUS
    if multi_pod:
        return make_mesh((2, data, NODE_GPUS), ("pod", "data", "model"),
                         devices)
    return make_mesh((data, NODE_GPUS), ("data", "model"), devices)


def make_dev_mesh(n_devices: int | None = None, tp: int = 1,
                  devices=None) -> CorpusMesh:
    """A small (n_devices // tp, tp) mesh over ``devices`` for tests and
    examples; ``n_devices`` defaults to the visible CUDA devices (or the
    length of ``devices``)."""
    import torch
    if n_devices is None:
        if devices is not None:
            n_devices = len(devices)
        else:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "a dev mesh places its positions on CUDA devices by "
                    "default and none is available; pass devices=['cpu'] "
                    "to place them on the host")
            n_devices = torch.cuda.device_count()
    if n_devices % tp:
        raise ValueError(f"{n_devices} devices not divisible by TP={tp}")
    return make_mesh((n_devices // tp, tp), ("data", "model"), devices)
