"""Dry-run of the port: every (architecture x input shape x mesh) cell
built at full width on ``meta`` tensors over the port's production
meshes, with its per-chip memory from the sharding rules, the FLOPs and
major bytes of one step walked by ``runtime.analysis.torch_cost``, and
the analytic HBM and collective bytes and roofline terms (port of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_3_2b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # the sweep

Results are JSON under ``experiments/dryrun_torch/`` (of the working
directory). Meta tensors need no device and no environment: the module
sets no variable and starts no process, and ``--all`` runs every cell in
this process (a failing cell is recorded and the sweep goes on).

Each cell: the model in bf16 at the mesh's tensor parallelism (its
shape rules: head, expert and vocab padding); the MoE archs with their
experts dealt over the mesh (``moe_apply_ep`` over the 256 or 512
``meta`` positions). Per chip: parameters (bf16), gradients and AdamW's
moments (fp32; train) and the serve cache (bf16; decode), each through
its specs (``runtime.sharding``), against the card's 80 GB. One step's
cost: train (forward and backward of one microbatch, times the
microbatches, plus the AdamW update), prefill, or decode (one token for
each sequence of a full cache), the layer stack walked at four small
depths and extrapolated (``runtime.analysis.stacked_cost``). The
reference's ``lower_s`` and ``compile_s`` (XLA) have no counterpart:
``build_s`` (the meta model and the specs) and ``walk_s`` (the cost walk)
take their place.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.convert import reference_shapes
from repro_torch.models.model import TrainHParams, grads_of, make_prefill
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adamw
from repro_torch.optim.schedules import cosine_with_warmup
from repro_torch.runtime import sharding as SH
from repro_torch.runtime.analysis import (analytic_collective_bytes,
                                          analytic_hbm_bytes, roofline_terms,
                                          stacked_cost, torch_cost)

SHAPES = {
    "train_4k":    dict(kind="train",   seq=4096,    gb=256),
    "prefill_32k": dict(kind="prefill", seq=32768,   gb=32),
    "decode_32k":  dict(kind="decode",  seq=32768,   gb=128),
    "long_500k":   dict(kind="decode",  seq=524288,  gb=1, seq_shard=True,
                        subquad_only=True),
}

OUT_DIR = os.path.abspath(os.path.join(os.getcwd(), "experiments",
                                       "dryrun_torch"))

DTYPE = torch.bfloat16
TP = 8                       # one 8-GPU NVLink node (launch/mesh.py)
HBM_BYTES = 80e9             # an H100's 80 GB
# params (bf16) + grads (fp32) + AdamW (fp32 m, v) under TP only must fit
# half the card, else shard them over the data axes too (FSDP)
FSDP_BUDGET = HBM_BYTES / 2
# live remat residuals of one microbatch (the reference's 3e9 of 16 GB,
# scaled to 80 GB)
MICROBATCH_BUDGET = 15e9
HEADROOM = 2 * 2**30


def cell_is_applicable(arch: str, shape: str) -> tuple[bool, str]:
    cfg = get_config(arch)
    sh = SHAPES[shape]
    if sh.get("subquad_only") and not cfg.sub_quadratic:
        return False, ("SKIP: long_500k requires sub-quadratic attention; "
                       f"{arch} is pure full-attention (DESIGN.md §5)")
    return True, ""


def needs_fsdp(cfg, tp: int = TP, budget_bytes: float = FSDP_BUDGET) -> bool:
    """params (bf16) + grads (fp32) + AdamW (fp32 m, v) under TP-only
    sharding must fit ``budget_bytes`` a chip, else shard over the data
    axes (the reference: tp 16, 8e9 of a 16 GB chip)."""
    return cfg.n_params() * (2 + 4 + 8) / tp > budget_bytes


def pick_microbatch(cfg, gb: int, seq: int, data_shards: int,
                    budget_bytes: float = MICROBATCH_BUDGET) -> int | None:
    """Largest microbatch whose sqrt-remat residuals fit the budget (the
    reference's arithmetic; its budget 3e9)."""
    nl = cfg.num_layers
    g = max(1, int(math.sqrt(nl)))
    live = g + nl // g
    full_tok = gb * seq / data_shards
    h_bytes = full_tok * cfg.d_model * 2 * live
    if h_bytes <= budget_bytes:
        return None                                  # no accumulation needed
    mb = gb
    while mb > data_shards:
        cand = mb // 2
        if gb % cand or cand < data_shards:
            break
        mb = cand
        if (mb * seq / data_shards) * cfg.d_model * 2 * live <= budget_bytes:
            return mb
    return mb


def model_flops_for(cfg, kind: str, gb: int, seq: int) -> float:
    n_active = cfg.n_active_params()
    if kind == "train":
        return 6.0 * n_active * gb * seq
    if kind == "prefill":
        return 2.0 * n_active * gb * seq
    return 2.0 * n_active * gb          # decode: one token per sequence


def remat_residual_bytes(cfg, tokens_loc: float) -> float:
    """Live sqrt-remat residuals of ``tokens_loc`` tokens a chip (bf16)."""
    g = max(1, int(math.sqrt(cfg.num_layers)))
    return tokens_loc * cfg.d_model * 2 * (g + cfg.num_layers // g)


def _meta_tokens(b: int, t: int) -> torch.Tensor:
    return torch.zeros((b, t), dtype=torch.long, device="meta")


def train_walk(mb: int, seq: int, nmb: int, mesh, hp: TrainHParams,
               tp: int = TP, dtype=DTYPE):
    """walk(cfg) -> Cost of one train step at cfg's depth: ``nmb`` times
    one microbatch's forward and backward (loss, ce, aux, remat), the
    gradients' 1 / nmb scaling when nmb > 1, then the lr schedule and the
    AdamW update with its clip. The model is built at ``tp`` in
    ``dtype`` on meta, its MoE layers expert parallel over ``mesh``."""
    def walk(cfg):
        model = Transformer(cfg, tp=tp, device="meta", dtype=dtype)
        tok = _meta_tokens(mb, seq)
        one = dataclasses.replace(hp, microbatch=None)
        cost = torch_cost(lambda m, b: grads_of(m, b, one, mesh)[0],
                          model, {"tokens": tok, "labels": tok}).scaled(nmb)
        params = dict(model.named_parameters())
        grads = {k: p.grad for k, p in params.items()}
        if nmb > 1:
            cost = cost + torch_cost(
                lambda g: [x.mul_(1.0 / nmb) for x in g.values()], grads)
        opt = adamw.init(params)

        def update(params, opt, grads):
            lr = cosine_with_warmup(opt.step + 1, peak_lr=hp.peak_lr,
                                    warmup_steps=hp.warmup_steps,
                                    total_steps=hp.total_steps)
            gnorm = adamw.update(grads, opt, params, lr,
                                 weight_decay=hp.weight_decay,
                                 clip_norm=hp.clip_norm)
            return params, opt, gnorm
        return cost + torch_cost(update, params, opt, grads)
    return walk


def prefill_walk(gb: int, seq: int, mesh, tp: int = TP, dtype=DTYPE):
    def walk(cfg):
        model = Transformer(cfg, tp=tp, device="meta", dtype=dtype)
        with torch.no_grad():
            return torch_cost(lambda m, t: make_prefill(m, mesh=mesh)(t),
                              model,
                              _meta_tokens(gb, seq))
    return walk


def decode_walk(gb: int, seq: int, mesh, tp: int = TP, dtype=DTYPE):
    def walk(cfg):
        model = Transformer(cfg, tp=tp, device="meta", dtype=dtype)
        cache = model.init_cache(gb, seq)
        cache["pos"] = seq - 1
        with torch.no_grad():
            return torch_cost(lambda m, c, t: m.decode_step(c, t, mesh)[0],
                              model,
                              cache, _meta_tokens(gb, 1))
    return walk


def run_cell(arch: str, shape: str, multi_pod: bool) -> dict:
    cfg = get_config(arch)
    sh = SHAPES[shape]
    kind, seq, gb = sh["kind"], sh["seq"], sh["gb"]
    t0 = time.perf_counter()
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"])
    n_chips = mesh.size
    tp = mesh.axis_size("model")
    data_shards = n_chips // tp
    res: dict = {"arch": arch, "shape": shape,
                 "mesh": "x".join(map(str, mesh.shape)),
                 "axis_names": list(mesh.axis_names), "kind": kind,
                 "n_chips": n_chips, "tp": tp, "dtype": "bfloat16"}
    dax = SH.data_axes(mesh)
    fsdp_axes = dax if needs_fsdp(cfg, tp) else ()
    res["fsdp"] = bool(fsdp_axes)
    ep_mesh = mesh if cfg.moe else None
    res["expert_parallel"] = ep_mesh is not None

    model = Transformer(cfg, tp=tp, device="meta", dtype=DTYPE)
    shapes = reference_shapes(model)
    pspecs = SH.param_specs(shapes, mesh, fsdp_axes)
    mem = {"params": SH.spec_bytes(shapes, pspecs, mesh, 2)}
    if kind == "train":
        mb = pick_microbatch(cfg, gb, seq, data_shards)
        res["microbatch"] = mb
        ospecs = SH.opt_state_specs(pspecs)
        mem["grads"] = SH.spec_bytes(shapes, pspecs, mesh, 4)
        mem["opt_state"] = 2 * SH.spec_bytes(shapes, ospecs.m, mesh, 4)
        mem["remat_residuals"] = remat_residual_bytes(
            cfg, (mb or gb) * seq / data_shards)
    elif kind == "decode":
        cache = model.init_cache(gb, seq)
        cspecs = SH.cache_specs(cache, mesh, bool(sh.get("seq_shard")))
        cshapes = {k: tuple(v.shape) for k, v in cache.items()
                   if isinstance(v, torch.Tensor)}
        mem["cache"] = SH.spec_bytes(cshapes, cspecs, mesh, 2)
        del cache
    total = float(sum(mem.values()))
    res["memory_per_chip"] = {**{k: float(v) for k, v in mem.items()},
                              "total_bytes": total,
                              "total_gib": total / 2**30,
                              "headroom_bytes": HEADROOM}
    res["fits_80gb"] = bool(total + HEADROOM <= HBM_BYTES)
    del model
    res["build_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if kind == "train":
        mb = res["microbatch"] or gb
        walk = train_walk(mb, seq, gb // mb, ep_mesh, TrainHParams(), tp)
        cost = stacked_cost(cfg, walk, remat=True)
    elif kind == "prefill":
        cost = stacked_cost(cfg, prefill_walk(gb, seq, ep_mesh, tp),
                            remat=False)
    else:
        cost = stacked_cost(cfg, decode_walk(gb, seq, ep_mesh, tp),
                            remat=False)
    res["walk_s"] = time.perf_counter() - t0
    res["torch_cost"] = cost.as_dict()

    hbm = analytic_hbm_bytes(cfg, kind, gb, seq, n_chips, tp)
    res["analytic_hbm_bytes_per_chip"] = hbm
    coll = analytic_collective_bytes(cfg, kind, gb, seq, n_chips, tp,
                                     res["fsdp"])
    # the collectives the walk made (the MoE's expert-parallel psums;
    # the other terms are analytic only), per chip
    coll["counted_calls"] = cost.collective_calls
    coll["counted_bytes_per_chip"] = cost.collective_bytes / n_chips
    res["collectives"] = coll
    res["roofline"] = roofline_terms(
        cost.flops, hbm * n_chips, coll["total_bytes"], n_chips,
        model_flops_for(cfg, kind, gb, seq))
    return res


def cell_path(arch: str, shape: str, mesh_tag: str,
              out_dir: str = OUT_DIR) -> str:
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_tag}.json")


def sweep(out_dir: str = OUT_DIR, force: bool = False,
          log=print) -> dict:
    """Every cell, in this process: ``{"cells", "skipped", "cached",
    "failures", "seconds"}``."""
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    out = {"cells": 0, "skipped": 0, "cached": 0, "failures": []}
    for arch in ARCH_IDS:
        for shape in SHAPES:
            ok, why = cell_is_applicable(arch, shape)
            for mesh_tag in ("single", "multi"):
                path = cell_path(arch, shape, mesh_tag, out_dir)
                if os.path.exists(path) and not force:
                    out["cached"] += 1
                    continue
                if not ok:
                    with open(path, "w") as f:
                        json.dump({"arch": arch, "shape": shape,
                                   "mesh": mesh_tag, "skipped": why}, f)
                    out["skipped"] += 1
                    continue
                try:
                    res = run_cell(arch, shape, mesh_tag == "multi")
                except Exception:
                    traceback.print_exc()
                    out["failures"].append([arch, shape, mesh_tag])
                    continue
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                out["cells"] += 1
                log(f"=== {arch} x {shape} x {mesh_tag}: build "
                    f"{res['build_s']:.2f} s, walk {res['walk_s']:.2f} s")
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    if args.all:
        res = sweep(args.out_dir, args.force)
        print(json.dumps(res))
        return 1 if res["failures"] else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    ok, why = cell_is_applicable(args.arch, args.shape)
    path = cell_path(args.arch, args.shape, args.mesh, args.out_dir)
    if os.path.exists(path) and not args.force:
        print(f"cached: {path}")
        return 0
    if not ok:
        print(why)
        return 0
    res = run_cell(args.arch, args.shape, multi_pod=(args.mesh == "multi"))
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    r = res["roofline"]
    print(json.dumps({k: res[k] for k in ("arch", "shape", "mesh",
                                          "build_s", "walk_s",
                                          "fits_80gb")}))
    print(f"memory/chip: {res['memory_per_chip']['total_gib']:.3f} GiB")
    print(f"terms: compute={r['compute_s']:.4g}s memory={r['memory_s']:.4g}s "
          f"collective={r['collective_s']:.4g}s dominant={r['dominant']} "
          f"useful={r['useful_ratio']:.3f} "
          f"roofline_mfu={r['roofline_mfu']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
