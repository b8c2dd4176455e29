"""Atomic checkpoints (port of ``repro.checkpoint.checkpointer``).

The reference's guarantees and format, so a checkpoint written by either
package restores in the other:

- atomicity: written to ``step_K.tmp/``, the manifest fsynced, then
  renamed to ``step_K/``; a crash mid-write never corrupts the latest
  checkpoint, and ``latest_step`` skips directories without a manifest;
- one ``.npz`` per top-level group and ``manifest.json`` with each
  group's keys, shapes, dtypes and a sha256 over (key, bytes) in key
  order, checked on restore;
- the logical layout: a group is a tree of nested dicts of arrays, keyed
  by its path joined with ``__``. :func:`train_state` gives a model and
  its AdamW state in the reference's layout (``params`` as
  ``to_reference`` stacks it; ``opt`` with the keys the reference's
  ``AdamWState`` flattens to: ``.step``, ``.m__<param path>``,
  ``.v__<param path>``), and :func:`load_train_state` writes them back.

The data pipeline is stateless (step-keyed), so (params, opt state,
step) is the whole job state.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

from repro_torch.models.convert import to_reference, to_state_dict
from repro_torch.optim.adamw import AdamWState


def _flatten(tree, prefix: str = ""):
    """(key, array) for every leaf of nested dicts, keys joined by "__"
    in sorted order."""
    if not isinstance(tree, dict):
        yield prefix, np.asarray(tree)
        return
    for k in sorted(tree):
        yield from _flatten(tree[k], f"{prefix}__{k}" if prefix else str(k))


def _digest(arrs) -> str:
    """sha256 over (key, bytes) in key order of a dict or an npz file."""
    h = hashlib.sha256()
    for k in sorted(arrs):
        h.update(k.encode())
        h.update(arrs[k].tobytes())
    return h.hexdigest()


def save(ckpt_dir: str, step: int, state: dict) -> str:
    """``state``: group name -> tree of nested dicts of arrays (host
    arrays). Returns the published directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest: dict = {"step": step, "groups": {}}
    for group, tree in state.items():
        arrs = dict(_flatten(tree))
        np.savez(os.path.join(tmp, f"{group}.npz"), **arrs)
        manifest["groups"][group] = {
            "keys": sorted(arrs), "sha256": _digest(arrs),
            "shapes": {k: list(v.shape) for k, v in arrs.items()},
            "dtypes": {k: str(v.dtype) for k, v in arrs.items()},
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)                      # atomic publish
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """The newest complete checkpoint's step (manifest present)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(name.split("_")[1]) for name in os.listdir(ckpt_dir)
             if name.startswith("step_") and not name.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, name,
                                             "manifest.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, template: dict,
            verify: bool = True) -> dict:
    """Group -> numpy arrays in the structure of ``template`` (a matching
    tree of nested dicts; only its keys are read). Raises ``IOError`` on
    a checksum mismatch when ``verify``."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for group, tree in template.items():
        with np.load(os.path.join(path, f"{group}.npz")) as data:
            if verify and _digest(data) != \
                    manifest["groups"][group]["sha256"]:
                raise IOError(f"checkpoint corruption in {group} at {path}")
            out[group] = _fill(tree, data)
    return out


def _fill(tree, data, prefix: str = ""):
    if not isinstance(tree, dict):
        return data[prefix]
    return {k: _fill(v, data, f"{prefix}__{k}" if prefix else str(k))
            for k, v in tree.items()}


def prune_old(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` published checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    names = sorted(n for n in os.listdir(ckpt_dir)
                   if n.startswith("step_") and not n.endswith(".tmp"))
    for name in names[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, name))


def train_state(model, opt: AdamWState) -> dict:
    """``{"params", "opt"}`` of a model and its AdamW state in the
    reference's logical layout (numpy on the host)."""
    return {"params": to_reference(model),
            "opt": {".step": opt.step.detach().cpu().numpy(),
                    ".m": to_reference(model, opt.m),
                    ".v": to_reference(model, opt.v)}}


@torch.no_grad()
def load_train_state(model, opt: AdamWState, state: dict) -> None:
    """Copy a restored ``{"params", "opt"}`` (the layout of
    :func:`train_state`) into ``model``'s parameters and ``opt``, in
    place."""
    cfg = model.cfg
    params = dict(model.named_parameters())
    for dst, tree in ((params, state["params"]),
                      (opt.m, state["opt"][".m"]),
                      (opt.v, state["opt"][".v"])):
        sd = to_state_dict(cfg, tree)
        if sd.keys() != dst.keys():
            raise KeyError(f"checkpoint leaves {sorted(sd.keys() ^ dst.keys())}"
                           " do not match the model")
        for k, t in dst.items():
            t.copy_(torch.from_numpy(np.require(sd[k], requirements="CW")))
    opt.step.copy_(torch.as_tensor(state["opt"][".step"]))
