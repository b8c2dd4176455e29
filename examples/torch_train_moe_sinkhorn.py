"""End-to-end training on the PyTorch port: an MoE LM with the
Sinkhorn-Knopp router (port of ``examples/train_moe_sinkhorn.py``).

    PYTHONPATH=src python examples/torch_train_moe_sinkhorn.py [--steps 300]
    PYTHONPATH=src python examples/torch_train_moe_sinkhorn.py \\
        --device cpu --steps 4 --batch 2 --seq-len 32         # host

Trains a ~100M-parameter qwen2-moe-family model (4 layers, d_model 512,
16 experts of 512, top-2, 1 shared, vocab 8192) on the step-keyed
synthetic pipeline, with the paper's Sinkhorn-Knopp solver doing the
token->expert balanced assignment, then compares router health (the
token-drop fraction at capacity) against the top-k router on fresh data
with the same trained weights. The card by default (raises without one).
"""
import argparse
import dataclasses
import sys
import time

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.device import resolve_device  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_at_step  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.moe import moe_dropped_fraction  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


def hundred_m_config(router: str):
    base = get_config("qwen2_moe_a2_7b")
    return dataclasses.replace(
        base, num_layers=4, d_model=512, num_heads=8, num_kv_heads=8,
        head_dim=64, vocab_size=8192,
        moe=dataclasses.replace(base.moe, n_experts=16, n_shared=1,
                                top_k=2, d_ff=512, router=router))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--router", default="sinkhorn",
                    choices=["sinkhorn", "topk"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the host)")
    return ap


def run(args) -> dict:
    """Train and print as the reference's example does; returns the logged
    steps ({step, loss, ce, aux, grad_norm}) and both routers' drop
    fractions."""
    device = resolve_device(args.device)
    cfg = hundred_m_config(args.router)
    model = Transformer(cfg, torch.Generator(device).manual_seed(0),
                        device=device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params/1e6:.1f}M params, router={args.router}")

    hp = M.TrainHParams(peak_lr=6e-4, warmup_steps=20, total_steps=args.steps)
    step_fn = M.make_train_step(model, hp)
    opt = adamw.init(dict(model.named_parameters()))
    dc = DataConfig(cfg.vocab_size, args.batch, args.seq_len, seed=0)

    log = []
    t0 = time.time()
    for step in range(args.steps):
        m = step_fn(opt, batch_at_step(dc, step))
        if step % 25 == 0 or step == args.steps - 1:
            rec = {"step": step, **{k: float(m[k]) for k in
                                    ("loss", "ce", "aux", "grad_norm")}}
            log.append(rec)
            print(f"step {step:4d}  loss {rec['loss']:.4f}  "
                  f"ce {rec['ce']:.4f}  aux {rec['aux']:.4f}  "
                  f"gnorm {rec['grad_norm']:.2f}")
    print(f"trained {args.steps} steps in {time.time()-t0:.1f}s")

    # router health on fresh data, both routers, same trained weights: the
    # first layer's MoE on the model's final hidden states, as the
    # reference's example measures it
    tokens = batch_at_step(dc, args.steps + 1)["tokens"].to(device)
    dropped = {}
    with torch.inference_mode():
        h = model(tokens)[0]
        for kind in ("topk", "sinkhorn"):
            dropped[kind] = float(moe_dropped_fraction(model.layers[0].moe,
                                                       h, kind))
            print(f"router={kind:8s} token-drop fraction at capacity: "
                  f"{dropped[kind]:.4f}")
    return {"n_params": n_params, "log": log, "dropped": dropped}


def main() -> None:
    run(build_parser().parse_args())


if __name__ == "__main__":
    main()
