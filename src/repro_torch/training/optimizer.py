"""Optimizers written by hand on tensors (port of
``repro/training/optimizer.py``): ``AdamW``, its int8-moment variant
``AdamW8bit``, ``global_norm``, ``apply_updates``, ``make_optimizer`` and
``cosine_schedule``.

The reference's update, step for step: f32 moments, the gradients clipped to
a global norm of 1.0 (``+1e-12`` in the divisor), bias correction, and the
decoupled weight decay added to the step direction ``u`` before ``-lr * u``.
``torch.optim.AdamW`` clips nothing and decays as ``p * (1 - lr * wd)``, so
it is not this update.  The API mirrors the reference's optax-like one over
a sequence of tensors instead of a pytree: ``init(params) -> state``,
``update(grads, state, params) -> (updates, state)``; the zoo's train step
passes the params' leaves in the reference's flatten order, so the state's
lists line up with the reference's tree leaf for leaf.

``AdamW8bit`` keeps m and v as :class:`Q8`: int8 in the parameter's shape
with one f32 scale for each trailing row (the reference's shape-preserving
layout), decoded to f32 for the update and encoded again after it.
Departure from the reference, which changes no value: the update runs one
leaf at a time, so ``AdamW8bit`` decodes each leaf's moments just before its
update where the reference decodes all of m and v at once (about 8 bytes a
parameter less transient memory), and ``AdamW`` holds one clipped gradient
at a time.
"""
from __future__ import annotations

import dataclasses
import math
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

    def _moment(self, z) -> torch.Tensor:
        """A stored moment as f32 (identity here; ``AdamW8bit`` decodes)."""
        return z

    def _store(self, x: torch.Tensor):
        """An updated f32 moment as stored (identity here; ``AdamW8bit``
        encodes)."""
        return x

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: AdamWState,
               params: Sequence[torch.Tensor], lr_scale: float = 1.0):
        step = state.step + 1
        scale = None
        if self.grad_clip_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.grad_clip_norm / (gnorm + 1e-12), max=1.0)
        b1, b2 = self.b1, self.b2
        t = step.float()
        mhat_scale = 1.0 / (1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                                       device=t.device), t))
        vhat_scale = 1.0 / (1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                                       device=t.device), t))
        lr = self.lr * lr_scale
        m, v, updates = [], [], []
        for g, mz, vz, p in zip(grads, state.m, state.v, params):
            if scale is not None:
                g = g * scale
            mm = b1 * self._moment(mz) + (1 - b1) * g.float()
            vv = b2 * self._moment(vz) + (1 - b2) * torch.square(g.float())
            u = (mm * mhat_scale) / (torch.sqrt(vv * vhat_scale) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            updates.append((-lr * u).to(p.dtype))
            m.append(self._store(mm))
            v.append(self._store(vv))
        return updates, AdamWState(step=step, m=m, v=v)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


def apply_updates(params: Sequence[torch.Tensor], updates: Sequence[torch.Tensor]) -> list:
    """``p + u`` for each pair (new tensors; the caller copies them back)."""
    return [p + u.to(p.dtype) for p, u in zip(params, updates)]


# ---------------------------------------------------------------------------
# int8 per-row-quantized moments
# ---------------------------------------------------------------------------

class Q8(NamedTuple):
    """A moment in int8 with one f32 scale per trailing row.  Its leaves
    flatten as ``(q, scale)``, as the reference's pytree registration."""
    q: torch.Tensor        # int8, the parameter's shape
    scale: torch.Tensor    # f32, shape[:-1] + (1,)


def _q8_encode(x: torch.Tensor) -> Q8:
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.round(x / scale).to(torch.int8)  # half to even, as jnp.round
    return Q8(q=q, scale=scale.float())


def _q8_decode(z: Q8) -> torch.Tensor:
    return z.q.float() * z.scale


@dataclasses.dataclass(frozen=True)
class AdamW8bit(AdamW):
    """AdamW with int8 m/v: decode -> update -> re-encode each step; the
    quantization error on m/v is bounded by the per-row scale."""

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        device = params[0].device if len(params) else None
        enc = lambda p: _q8_encode(torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                               device=p.device))
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            m=[enc(p) for p in params],
            v=[enc(p) for p in params],
        )

    def _moment(self, z: Q8) -> torch.Tensor:
        return _q8_decode(z)

    def _store(self, x: torch.Tensor) -> Q8:
        return _q8_encode(x)


def make_optimizer(name: str, lr: float, weight_decay: float = 0.0, **kw) -> AdamW:
    if name == "adamw":
        return AdamW(lr=lr, weight_decay=weight_decay, **kw)
    if name == "adamw8bit":
        return AdamW8bit(lr=lr, weight_decay=weight_decay, **kw)
    raise ValueError(name)


def cosine_schedule(step, *, base, warmup: int, total: int, min_frac: float = 0.1) -> torch.Tensor:
    """lr multiplier (not absolute lr): linear warmup then cosine decay; a
    0-d f32 tensor, computed in f32 as the reference's."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    del base
    return warm * cos
