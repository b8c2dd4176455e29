"""Training launcher of the port: config-driven, resumable (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \\
        --reduced --steps 6 --ckpt-dir /tmp/run1 --ckpt-every 3 \\
        --device cpu                                          # host run
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \\
        --steps 6 --global-batch 8 --seq-len 1024             # the card

Every flag of the reference plus ``--device`` (the card by default;
raises without one). Atomic checkpoints in the reference's format and
auto-resume (``--resume auto``), the stateless step-keyed pipeline
(restart-exact), ``StepGuard`` retries, the heartbeat, a non-finite loss
as a poison step (``SystemExit``), the MoE router flag. Prints the
reference's JSON line every ``--log-every`` steps and at the last.
``--grad-compression int8`` creates the error-feedback residual and, as
in the reference's single-host driver, applies nothing: one process has
no cross-node reduction to compress.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import DataConfig, batch_at_step
from repro_torch.models import model as M
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adamw
from repro_torch.runtime import compression as C
from repro_torch.runtime.fault_tolerance import Heartbeat, StepGuard


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--router", choices=["sinkhorn", "topk"], default=None)
    ap.add_argument("--grad-compression", choices=["none", "int8"],
                    default="none")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", choices=["auto", "none"], default="auto")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the "
                         "host)")
    return ap


def run(args, hook=None) -> list[dict]:
    """Train as ``args`` say; returns the logged records. ``hook(step,
    metrics, model)``, when given, is called at the end of each step,
    after its loss was read, its line logged and its checkpoint saved."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.router and cfg.moe:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, router=args.router))
    device = resolve_device(args.device)

    hp = M.TrainHParams(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps, microbatch=args.microbatch)
    dc = DataConfig(vocab_size=cfg.vocab_size, global_batch=args.global_batch,
                    seq_len=args.seq_len, seed=args.seed)
    model = Transformer(cfg, torch.Generator(device).manual_seed(args.seed),
                        device=device)
    opt = adamw.init(dict(model.named_parameters()))
    step_fn = M.make_train_step(model, hp)
    start = 0
    if args.ckpt_dir and args.resume == "auto":
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            tmpl = ckpt.train_state(model, opt)
            ckpt.load_train_state(model, opt, ckpt.restore(
                args.ckpt_dir, latest, tmpl))
            start = latest
            print(f"resumed from step {start}")

    if args.grad_compression == "int8":
        # as the reference's driver: the residual exists and nothing is
        # compressed (one process has no cross-node reduction)
        C.zero_residual(dict(model.named_parameters()))
    guard = StepGuard()
    hb = Heartbeat()
    t_start = time.time()
    records = []
    for step in range(start, args.steps):
        batch = batch_at_step(dc, step)
        t0 = time.time()
        metrics = guard.run(step_fn, opt, batch)
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise SystemExit(f"poison step at {step}: loss={loss}")
        hb.record(0, time.time() - t0)
        if step % args.log_every == 0 or step == args.steps - 1:
            rec = {"step": step, "loss": round(loss, 4),
                   "ce": round(float(metrics["ce"]), 4),
                   "grad_norm": round(float(metrics["grad_norm"]), 3),
                   "lr": float(metrics["lr"]),
                   "s_per_step": round(time.time() - t0, 3)}
            records.append(rec)
            print(json.dumps(rec), flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            path = ckpt.save(args.ckpt_dir, step + 1,
                             ckpt.train_state(model, opt))
            ckpt.prune_old(args.ckpt_dir, keep=3)
            print(f"checkpoint: {path}")
        if hook is not None:
            hook(step, metrics, model)

    print(f"done: {args.steps - start} steps in "
          f"{time.time() - t_start:.1f}s")
    return records


def main(argv=None) -> None:
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
