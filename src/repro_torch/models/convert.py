"""Carry the reference's LM weights into the port.

The reference keeps its parameters as a pytree of arrays with every
per-layer leaf stacked on a leading layer dimension (the hybrid's on two,
groups x layers in a group, its remainder in ``layers_rem`` and its one
shared block unstacked) and dense matrices in (in, out) layout (``x @
W``). Given that pytree as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``), :func:`from_reference` builds the
port's :class:`Transformer` computing the same function: it unstacks the
layers into the blocks (the hybrid's layer i = g * attn_every + e, the
remainder after the groups) and transposes into the ``nn.Linear`` layout
(out, in) exactly the matrices that run through ``F.linear``
(:data:`LINEAR`). Every other leaf keeps its layout: the stacked expert
weights (E, d, f) run through ``torch.bmm`` as the reference's batched
einsum does, and rwkv6's ``mu`` and ``u`` and mamba2's conv windows are
read as the reference reads them. :func:`to_reference` is the inverse:
the port's parameters (or any tensors keyed by parameter name, such as
AdamW's moments) back into the reference's stacked pytree, which the
checkpoints store.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from .transformer import Transformer


# the leaves applied with F.linear, by their path inside a block (or at
# the top of the tree)
LINEAR = frozenset({
    "lm_head",
    "attn.wq", "attn.wk", "attn.wv", "attn.wo",
    "mlp.w_gate", "mlp.w_up", "mlp.w_down", "mlp.w_in", "mlp.w_out",
    "moe.router", "moe.shared.w_gate", "moe.shared.w_up",
    "moe.shared.w_down",
    "tmix.wr", "tmix.wk", "tmix.wv", "tmix.wg", "tmix.wo", "tmix.w1",
    "tmix.w2", "cmix.w_in", "cmix.w_out",
    "mamba.w_z", "mamba.w_x", "mamba.w_bc", "mamba.w_dt", "mamba.out_proj",
})


def _layout(path: str, arr: np.ndarray) -> np.ndarray:
    """One layer's (or the top's) leaf at ``path`` in the port's layout:
    transposed where :data:`LINEAR` names it."""
    if path not in LINEAR:
        return arr
    if arr.ndim != 2:
        raise ValueError(f"{path}: a linear weight must be 2-D, got shape "
                         f"{arr.shape}")
    return arr.T


def _leaves(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _leaves(val, name + ".")
        else:
            yield name, np.asarray(val)


def _unstack(sd: dict, tree: dict, lead: tuple, first: int) -> None:
    """Layers ``first``, ``first + 1``, ... of ``sd`` from leaves stacked
    on the leading dims ``lead`` (layer-major)."""
    n = int(np.prod(lead))
    for name, arr in _leaves(tree):
        if arr.shape[:len(lead)] != lead:
            raise ValueError(f"layers.{name}: leading dims "
                             f"{arr.shape[:len(lead)]} != {lead}")
        arr = arr.reshape((n,) + arr.shape[len(lead):])
        for i in range(n):
            sd[f"layers.{first + i}.{name}"] = _layout(name, arr[i])


def to_state_dict(cfg: ArchConfig, params: dict) -> dict:
    """The port's ``state_dict`` (numpy arrays) for the reference's
    parameter pytree: per-layer leaves unstacked, the :data:`LINEAR`
    matrices transposed."""
    sd = {"embed": np.asarray(params["embed"])}
    for name, arr in _leaves(params["final_norm"], "final_norm."):
        sd[name] = arr
    if "lm_head" in params:
        sd["lm_head"] = _layout("lm_head", np.asarray(params["lm_head"]))
    if cfg.family != "hybrid":
        _unstack(sd, params["layers"], (cfg.num_layers,), 0)
        return sd
    k = cfg.attn_every
    n_groups = cfg.num_layers // k
    _unstack(sd, params["layers"], (n_groups, k), 0)
    if n_groups * k < cfg.num_layers:
        _unstack(sd, params["layers_rem"], (cfg.num_layers - n_groups * k,),
                 n_groups * k)
    for name, arr in _leaves(params["shared_block"]):
        sd[f"shared_block.{name}"] = _layout(name, arr)
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


def _set(tree: dict, path: str, val) -> None:
    *heads, last = path.split(".")
    for h in heads:
        tree = tree.setdefault(h, {})
    tree[last] = val


def _stack(rows: list, lead: tuple) -> dict:
    """Layer leaves (one dict of leaf path -> array per layer) stacked on
    the leading dims ``lead`` (layer-major), in the reference's layout."""
    tree: dict = {}
    for name in rows[0]:
        arr = np.stack([_layout(name, r[name]) for r in rows])
        _set(tree, name, arr.reshape(lead + arr.shape[1:]))
    return tree


def reference_tree(cfg: ArchConfig, sd: dict) -> dict:
    """The reference's parameter pytree (nested dicts of numpy arrays) for
    a port state dict ``sd`` (parameter name -> array): the inverse of
    :func:`to_state_dict`, layers restacked (the hybrid's as groups x
    layers, plus ``layers_rem``) and the :data:`LINEAR` matrices
    transposed back."""
    tree: dict = {}
    layers: dict = {}
    for name, arr in sd.items():
        arr = np.asarray(arr)
        if name.startswith("layers."):
            _, i, leaf = name.split(".", 2)
            layers.setdefault(int(i), {})[leaf] = arr
        elif name.startswith("shared_block."):
            leaf = name.split(".", 1)[1]
            _set(tree, name, _layout(leaf, arr))
        else:
            _set(tree, name, _layout(name, arr))
    rows = [layers[i] for i in range(cfg.num_layers)]
    if cfg.family != "hybrid":
        tree["layers"] = _stack(rows, (cfg.num_layers,))
        return tree
    k = cfg.attn_every
    n_full = cfg.num_layers // k * k
    tree["layers"] = _stack(rows[:n_full], (n_full // k, k))
    if n_full < cfg.num_layers:
        tree["layers_rem"] = _stack(rows[n_full:],
                                    (cfg.num_layers - n_full,))
    return tree


def to_reference(model: Transformer, tensors: dict | None = None) -> dict:
    """The reference's pytree of numpy arrays for ``model``'s parameters,
    or for ``tensors`` keyed by its parameter names (AdamW's m and v)."""
    if tensors is None:
        tensors = dict(model.named_parameters())
    return reference_tree(model.cfg, {k: t.detach().cpu().numpy()
                                      for k, t in tensors.items()})


def reference_leaf(cfg: ArchConfig, name: str) -> tuple:
    """Where the port parameter ``name`` lives in the reference's pytree:
    (its path 'a/b/c', the leading stack dims it shares with the other
    layers there, whether its matrix is transposed (:data:`LINEAR`))."""
    if name.startswith("layers."):
        _, i, leaf = name.split(".", 2)
        top, lead = "layers", (cfg.num_layers,)
        if cfg.family == "hybrid":
            k = cfg.attn_every
            n_full = cfg.num_layers // k * k
            top, lead = (("layers", (n_full // k, k)) if int(i) < n_full
                         else ("layers_rem", (cfg.num_layers - n_full,)))
        path = f"{top}/{leaf}"
    elif name.startswith("shared_block."):
        leaf = name.split(".", 1)[1]
        path, lead = f"shared_block/{leaf}", ()
    else:
        leaf, path, lead = name, name, ()
    return path.replace(".", "/"), lead, leaf in LINEAR


def reference_shapes(model: Transformer) -> dict:
    """``{reference path: shape}`` of ``model``'s parameters in the
    reference's stacked layout (a meta model will do: only shapes are
    read)."""
    out = {}
    for name, p in model.named_parameters():
        path, lead, transposed = reference_leaf(model.cfg, name)
        shape = tuple(p.shape)
        out[path] = lead + (shape[::-1] if transposed else shape)
    return out
