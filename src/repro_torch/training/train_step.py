"""Training step (port of ``repro/training/train_step.py``): the LM loss,
remat and microbatch gradient accumulation, and the optimizer update.

``make_train_step(cfg, optimizer, microbatches=M)`` builds

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)

over the training form of the params (``params_from_numpy(...,
trainable=True)``: the reference's stacked tree of f32 leaves).

* ``batch["tokens"]``: (B, S+1) int32, next-token LM loss over all positions;
  ``batch["enc_input"]``: optional (B, S_enc, D) stub frontend embeddings.
* Each microbatch's backward accumulates into the leaves' f32 ``.grad`` as
  autograd delivers it: a running sum over the microbatches in order, then
  divided by M, as the reference's scan adds each microbatch's gradients to
  its f32 accumulator.  With M == 1 the gradients are used as they come.
* The loss is softmax cross-entropy in f32 with the padded vocabulary's
  columns masked out of the logsumexp.
* Metrics: ``loss`` and ``grad_norm`` (the global norm of the gradients
  before clipping), as 0-d f32 tensors.

Departures from the reference, none of which changes a value:
  * the params are updated in place (``p += u``, the value of the reference's
    ``apply_updates``) and the same tree is returned, where the reference's
    jitted step donates its buffers and returns new ones; the gradients are
    dropped (``.grad = None``) once the optimizer has used them;
  * the optimizer takes the params' :func:`~repro_torch.zoo.configs.base.leaves`
    (the reference's flatten order, dict keys sorted), so its state lines up
    with the reference's leaf for leaf.

Under a sharding context the params are DTensors; the gradients are pinned
to the params' logical axes once accumulated (the reference's
``constrain_like_params``: the ZeRO-style reduce-scatter onto the FSDP
shards), a no-op without a context.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.sharding import rules as sh
from repro_torch.sharding.rules import shard
from repro_torch.training import optimizer as opt_mod
from repro_torch.zoo.configs.base import ModelConfig, leaves, model_spec_tree
from repro_torch.zoo.models.transformer import model_forward


def lm_loss(params, cfg: ModelConfig, tokens: torch.Tensor,
            enc_input: Optional[torch.Tensor] = None, *, remat: bool = True,
            remat_group: int = 1) -> torch.Tensor:
    """Mean next-token cross entropy.  tokens: (b, s+1)."""
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    logits, _ = model_forward(params, cfg, inputs, enc_input=enc_input, remat=remat,
                              remat_group=remat_group)
    logits = logits.float()
    if cfg.padded_vocab != cfg.vocab_size:  # mask pad columns out of the lse
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(col < cfg.vocab_size, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    return (lse - _picked(logits, labels)).mean()


def _picked(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The label's logit of each position.  Over vocab-sharded DTensor
    logits each rank gathers the labels in its slice of the vocabulary and
    the partial results sum over the ranks that split it."""
    if not sh.is_dtensor(logits):
        return logits.gather(-1, labels.long()[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    lp = tuple(logits.placements)
    n, lo = sh.local_range(logits, 2)
    out = [Partial() if p == Shard(2) else (p if p == Shard(0) else Replicate()) for p in lp]
    lab = [Shard(0) if p == Shard(0) else Replicate() for p in lp]

    def local(lg, lb):
        idx = lb.long() - lo
        ok = (idx >= 0) & (idx < n)
        v = lg.gather(-1, idx.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where(ok, v, torch.zeros((), dtype=v.dtype, device=v.device))

    fn = local_map(local, out_placements=out, in_placements=(list(lp), lab),
                   in_grad_placements=(list(lp), lab), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(logits, labels).redistribute(mesh, lab)


def loss_and_grads(params, cfg: ModelConfig, tokens: torch.Tensor,
                   enc_input: Optional[torch.Tensor] = None, *, microbatches: int = 1,
                   remat: bool = True, remat_group: int = 1):
    """The step's loss and gradients: (loss, grads), ``grads`` the ``.grad``
    of each of ``leaves(params)`` (f32 for f32 leaves), accumulated over
    ``microbatches`` equal slices of the batch and divided by their count.
    The leaves' ``.grad`` must be None on entry; they hold the gradients on
    return."""
    plist = leaves(params)
    if any(p.grad is not None for p in plist):
        raise ValueError("loss_and_grads: the params carry gradients from an earlier step")
    b = tokens.shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
    loss = None
    for i in range(microbatches):
        enc = None if enc_input is None else sh.microbatch(enc_input, i, microbatches)
        li = lm_loss(params, cfg, sh.microbatch(tokens, i, microbatches), enc, remat=remat,
                     remat_group=remat_group)
        li.backward()
        li = li.detach()
        loss = li if loss is None else loss + li
    if microbatches > 1:
        loss = loss / microbatches
        for p in plist:
            if p.grad is not None:
                p.grad.div_(microbatches)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in plist]
    return loss, grads


def make_train_step(cfg: ModelConfig, optimizer: opt_mod.AdamW, *, microbatches: int = 1,
                    remat: bool = True, remat_group: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` for the training form of ``cfg``'s params."""
    spec_axes = [sp.axes for sp in leaves(model_spec_tree(cfg))]

    def constrain_like_params(grads):
        """Pin gradient shardings to the parameters' logical axes."""
        return [shard(g, ax) for g, ax in zip(grads, spec_axes)]

    def train_step(params, opt_state, batch):
        plist = leaves(params)
        try:
            loss, grads = loss_and_grads(params, cfg, batch["tokens"], batch.get("enc_input"),
                                         microbatches=microbatches, remat=remat,
                                         remat_group=remat_group)
            grads = constrain_like_params(grads)
            grad_norm = opt_mod.global_norm(grads)
            updates, opt_state = optimizer.update(grads, opt_state, plist)
        finally:
            for p in plist:
                p.grad = None
        del grads
        with torch.no_grad():
            for p, u in zip(plist, updates):
                p.add_(u.to(p.dtype))
        return params, opt_state, {"loss": loss, "grad_norm": grad_norm}

    return train_step
