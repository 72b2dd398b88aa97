"""AdamW written by hand on tensors (port of ``repro/training/optimizer.py``:
``AdamW``, ``global_norm``, ``apply_updates``).

The reference's update, step for step: f32 moments, the gradients clipped to
a global norm of 1.0 (``+1e-12`` in the divisor), bias correction, and the
decoupled weight decay added to the step direction ``u`` before ``-lr * u``.
``torch.optim.AdamW`` clips nothing and decays as ``p * (1 - lr * wd)``, so
it is not this update.  The API mirrors the reference's optax-like one over
a sequence of tensors instead of a pytree: ``init(params) -> state``,
``update(grads, state, params) -> (updates, state)``.  The int8-moment
variant, ``make_optimizer`` and ``cosine_schedule`` serve the zoo's training
and are not ported (ROADMAP Queue 1, item 8).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    m: list
    v: list


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = 1.0

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        device = params[0].device if len(params) else None
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            m=[torch.zeros_like(p, dtype=torch.float32) for p in params],
            v=[torch.zeros_like(p, dtype=torch.float32) for p in params],
        )

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: AdamWState,
               params: Sequence[torch.Tensor], lr_scale: float = 1.0):
        step = state.step + 1
        if self.grad_clip_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.grad_clip_norm / (gnorm + 1e-12), max=1.0)
            grads = [g * scale for g in grads]
        b1, b2 = self.b1, self.b2
        m = [b1 * mm + (1 - b1) * g.float() for mm, g in zip(state.m, grads)]
        v = [b2 * vv + (1 - b2) * torch.square(g.float()) for vv, g in zip(state.v, grads)]
        t = step.float()
        mhat_scale = 1.0 / (1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                                       device=t.device), t))
        vhat_scale = 1.0 / (1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                                       device=t.device), t))
        lr = self.lr * lr_scale

        def upd(p, mm, vv):
            u = (mm * mhat_scale) / (torch.sqrt(vv * vhat_scale) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            return (-lr * u).to(p.dtype)

        updates = [upd(p, mm, vv) for p, mm, vv in zip(params, m, v)]
        return updates, AdamWState(step=step, m=m, v=v)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


def apply_updates(params: Sequence[torch.Tensor], updates: Sequence[torch.Tensor]) -> list:
    """``p + u`` for each pair (new tensors; the caller copies them back)."""
    return [p + u.to(p.dtype) for p, u in zip(params, updates)]
