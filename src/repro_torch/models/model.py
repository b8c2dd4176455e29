"""Model bundle of the port (port of ``repro.models.model``): the train
step, the serve step and the prefill of a :class:`Transformer`.

``make_train_step`` updates the model's parameters and the AdamW state in
place; ``make_serve_step`` and ``make_prefill`` are the LM decode server's
callables, to be called under ``torch.inference_mode()``. Each takes a
``mesh`` (default: the model's own): with one, the MoE layers run expert
parallel over it (``models.moe.moe_apply_ep``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.optim import adamw
from repro_torch.optim.schedules import cosine_with_warmup
from .transformer import Transformer


@dataclass(frozen=True)
class TrainHParams:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    aux_loss_weight: float = 0.01    # MoE load-balance term
    remat: bool = True
    microbatch: int | None = None    # grad-accumulation microbatch size


def grads_of(model: Transformer, batch: dict, hp: TrainHParams,
             mesh=None):
    """Loss, ce and aux of ``batch`` {tokens, labels} (B, T), with their
    gradients left in each parameter's ``.grad`` (fp32). The loss is ``ce
    + aux_loss_weight * aux``. With ``hp.microbatch`` below B the batch
    runs in B // microbatch slices, gradients summed in ``.grad`` and then
    scaled by 1 / (the slice count), as are the three scalars."""
    dev = model.embed.device
    tokens = batch["tokens"].to(dev, non_blocking=True)
    labels = batch["labels"].to(dev, non_blocking=True)
    gb = tokens.shape[0]
    mb = hp.microbatch if hp.microbatch and hp.microbatch < gb else gb
    if gb % mb:
        raise ValueError(f"global batch {gb} does not divide into "
                         f"microbatches of {mb}")
    for p in model.parameters():
        p.grad = None
    loss = ce = aux = 0.0
    for s in range(0, gb, mb):
        hidden, a = model(tokens[s:s + mb], remat=hp.remat, mesh=mesh)
        c = model.lm_loss(hidden, labels[s:s + mb])
        a = a.float()
        lo = c + hp.aux_loss_weight * a
        lo.backward()
        loss, ce, aux = loss + lo.detach(), ce + c.detach(), aux + a.detach()
    nmb = gb // mb
    if nmb > 1:
        inv = 1.0 / nmb
        for p in model.parameters():
            if p.grad is not None:
                p.grad.mul_(inv)
        loss, ce, aux = loss * inv, ce * inv, aux * inv
    return loss, ce, aux


def make_train_step(model: Transformer, hp: TrainHParams = TrainHParams(),
                    mesh=None) -> Callable:
    """(opt_state, batch{tokens, labels}) -> metrics {loss, ce, aux,
    grad_norm, lr} (scalar tensors on the model's device, not synced).
    One step of the reference's ``train_step``: :func:`grads_of`, lr from
    ``cosine_with_warmup(opt_state.step + 1)``, then ``adamw.update`` of
    the model's parameters and ``opt_state`` in place.

    The reference's ``tp`` and ``batch_axes`` have no counterpart here:
    ``tp`` is fixed when the model is built (its shape rules), and
    ``batch_axes`` is a sharding hint for SPMD that a single-device step
    does not need. ``mesh`` runs the MoE layers expert parallel, as the
    reference's step does under its ``layers.MESH``."""
    params = dict(model.named_parameters())

    def train_step(opt_state: adamw.AdamWState, batch: dict) -> dict:
        loss, ce, aux = grads_of(model, batch, hp, mesh)
        lr = cosine_with_warmup(opt_state.step + 1, peak_lr=hp.peak_lr,
                                warmup_steps=hp.warmup_steps,
                                total_steps=hp.total_steps)
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        gnorm = adamw.update(grads, opt_state, params, lr,
                             weight_decay=hp.weight_decay,
                             clip_norm=hp.clip_norm)
        return {"loss": loss, "ce": ce, "aux": aux, "grad_norm": gnorm,
                "lr": lr}

    return train_step


def make_serve_step(model: Transformer, mesh=None) -> Callable:
    """(cache, tokens (B, 1)) -> (next_tokens (B, 1), logits (B, V), cache):
    one greedy decode step; the cache advances in place."""

    def serve_step(cache: dict, tokens: torch.Tensor):
        logits, cache = model.decode_step(cache, tokens, mesh)
        nxt = logits.argmax(-1).to(tokens.dtype)[:, None]
        return nxt, logits, cache

    return serve_step


def make_prefill(model: Transformer, block_k: int = 512,
                 mesh=None) -> Callable:
    """tokens (B, T) -> logits (B, Vp) of the last position, fp32: the
    inference forward (no loss, no grads)."""

    def prefill(tokens: torch.Tensor) -> torch.Tensor:
        hidden, _ = model(tokens, block_k, mesh=mesh)
        return F.linear(hidden[:, -1], model.lm_head_matrix()).float()

    return prefill
