"""AdamW with global-norm clipping (port of ``repro.optim.adamw``).

The reference's formula exactly: gradients scaled by ``min(1, clip /
max(gnorm, 1e-12))``, fp32 moments, eps added to ``sqrt(v_hat)``, weight
decay on every leaf from the old parameter. ``torch.optim.AdamW`` and
``clip_grad_norm_`` differ (their clip divides by ``gnorm + 1e-6``), so
neither is used. Parameters, moments and gradients are updated in place,
one leaf at a time: no temporary is larger than one leaf.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class AdamWState:
    """``step`` (int32 scalar on the parameters' device) and the fp32
    moments ``m`` and ``v``, keyed as the parameters are."""
    step: torch.Tensor
    m: dict
    v: dict


def init(params: dict) -> AdamWState:
    """Zero state for ``params`` (name -> tensor): fp32 moments whatever
    the parameters' dtype."""
    dev = next(iter(params.values())).device

    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                for k, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros(), v=zeros())


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def update(grads: dict, state: AdamWState, params: dict, lr, *,
           b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
           weight_decay: float = 0.1, clip_norm: float = 1.0) -> torch.Tensor:
    """One AdamW step, in place: ``params``, ``state`` and ``grads`` (which
    end up scaled by the clip factor). ``lr`` may be a scalar tensor (the
    schedule's output). Returns the global norm of the unscaled grads."""
    gnorm = global_norm(grads.values())
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    state.step += 1
    t = state.step.float()
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    for k, p in params.items():
        g = grads[k].mul_(scale)
        m = state.m[k].mul_(b1).add_(g, alpha=1 - b1)
        v = state.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
        u = torch.div(v, bc2).sqrt_().add_(eps)       # sqrt(v_hat) + eps
        u = torch.div(m, bc1).div_(u)                 # m_hat / that
        u.add_(p, alpha=weight_decay).mul_(lr)
        p.sub_(u.to(p.dtype))
    return gnorm
