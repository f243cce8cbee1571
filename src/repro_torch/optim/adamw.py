"""AdamW with global-norm clipping and mixed precision (float32 moments
whatever the param dtype): the JAX package's ``optim/adamw.py`` on dicts
of tensors.

``update`` writes the params and the moments in place under
``torch.no_grad()`` and returns them. Not ``torch.optim.AdamW``: JAX's
decay is added to the normalized step (``lr * (m̂ / (√v̂ + eps) + wd *
p)``, on matrices only) and its ``eps`` sits outside the square root, as
here. The step counter, the learning rate and the bias corrections stay
on the device, so a step reads nothing back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.tree import leaves, tree_map


@dataclass
class AdamWState:
    """step: 0-d int32 tensor; mu, nu: float32 trees shaped as the
    params."""

    step: torch.Tensor
    mu: Any
    nu: Any


def init(params) -> AdamWState:
    zeros = lambda: tree_map(  # noqa: E731
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
    first = leaves(params)[0]
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      mu=zeros(), nu=zeros())


def global_norm(grads) -> torch.Tensor:
    """The float32 2-norm over every leaf (0-d tensor)."""
    return torch.sqrt(sum(g.float().square().sum() for g in leaves(grads)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


@torch.no_grad()
def update(params, grads, state: AdamWState, lr, cfg: TrainConfig
           ) -> Tuple[Any, AdamWState]:
    """One AdamW step, in place: the grads clipped to ``cfg.grad_clip``,
    bias corrections from the incremented step, decoupled weight decay on
    tensors with ``ndim >= 2``, the update in float32 cast back to each
    param's dtype. ``lr``: a float or a 0-d tensor. Returns (params,
    state), the objects given."""
    grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    state.step += 1
    b1, b2 = cfg.beta1, cfg.beta2
    t = state.step.float()
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu),
                          leaves(state.nu)):
        g32 = g.float()
        m.mul_(b1).add_(g32, alpha=1 - b1)
        v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
        delta = (m / bc1) / ((v / bc2).sqrt_() + 1e-8)
        if p.ndim >= 2:
            delta.add_(p.float(), alpha=cfg.weight_decay)
        delta.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.float().sub_(delta))
    return params, state
