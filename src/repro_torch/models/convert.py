"""Carry the reference's LM weights into the port.

The reference keeps its parameters as a pytree of arrays with every
per-layer leaf stacked on a leading layer dimension and dense matrices in
(in, out) layout (``x @ W``). Given that pytree as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)``), :func:`from_reference`
builds the port's :class:`Transformer` computing the same function: it
unstacks ``params["layers"]`` into the blocks and transposes every dense
matrix into the ``nn.Linear`` layout (out, in). The stacked expert weights
(E, d, f) keep their layout; they run through ``torch.bmm`` as the
reference's batched einsum does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from .transformer import Transformer


def _leaves(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _leaves(val, name + ".")
        else:
            yield name, np.asarray(val)


def to_state_dict(cfg: ArchConfig, params: dict) -> dict:
    """The port's ``state_dict`` (numpy arrays) for the reference's
    parameter pytree: per-layer leaves unstacked, dense matrices (2-D per
    layer, and the LM head) transposed."""
    sd = {"embed": np.asarray(params["embed"])}
    for name, arr in _leaves(params["final_norm"], "final_norm."):
        sd[name] = arr
    if "lm_head" in params:
        sd["lm_head"] = np.asarray(params["lm_head"]).T
    for name, arr in _leaves(params["layers"]):
        if arr.shape[0] != cfg.num_layers:
            raise ValueError(f"layers.{name}: leading dim {arr.shape[0]} "
                             f"!= num_layers {cfg.num_layers}")
        for i in range(cfg.num_layers):
            sd[f"layers.{i}.{name}"] = arr[i].T if arr.ndim == 3 else arr[i]
    return sd


def from_reference(cfg: ArchConfig, params: dict, tp: int = 1, device=None,
                   dtype=torch.float32) -> Transformer:
    """The port's model holding the reference's weights ``params`` (built
    with the same ``cfg`` and ``tp``), on ``device`` (``cuda`` by default)."""
    device = resolve_device(device)
    model = Transformer(cfg, tp=tp, device="meta", dtype=dtype)
    sd = {k: torch.as_tensor(np.array(v), dtype=dtype,
                             device=device)
          for k, v in to_state_dict(cfg, params).items()}
    model.load_state_dict(sd, strict=True, assign=True)
    return model
