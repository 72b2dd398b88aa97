"""Logical-axis -> mesh-axis sharding rules over a ``DeviceMesh`` (port of
``repro/sharding/rules.py``).

Model code annotates activations with *logical* axes (``batch``, ``seq``,
``heads`` ...); parameters carry logical axes in their
:class:`repro_torch.zoo.configs.base.ParamSpec`.  This module maps them onto
the production mesh:

  single pod:  (16, 16)    axes ("data", "model")
  multi-pod:   (2, 16, 16) axes ("pod", "data", "model")

Rules (Megatron-style TP over "model", DP over "pod"+"data"):

  batch       -> ("pod", "data")      activations' leading dim
  seq_shard   -> "model"              sequence-parallel residuals (off)
  heads/kv_heads/heads_flat -> model  attention TP
  d_ff        -> model                MLP TP
  vocab       -> model                embedding/logits TP
  experts     -> model                expert parallelism
  d_model     -> None (or "data" under FSDP)
  layers      -> None                 the stacked super-block axis

A dim is left unsharded whenever its size does not divide the mesh axis
(e.g. kv_heads=8 on model=16 -> replicated KV, standard GQA TP).

The reference's ``PartitionSpec`` is a tuple here, one entry per dim (None,
a mesh axis name, or a tuple of names), and its ``NamedSharding`` is the
DTensor placements that spec gives (:func:`placements`: one ``Shard`` or
``Replicate`` per mesh dim; a dim over several mesh axes is split over them
in mesh order, major first, as GSPMD splits it).  :func:`shard` is
``with_sharding_constraint``: a ``redistribute`` of a DTensor to the spec's
placements under :func:`use_sharding`, and ``x`` itself without a context.

Where the reference leaves the layout of a weight's use to GSPMD, the port
says it: :func:`gather_params` all-gathers a param's FSDP shards (its
placements over the batch axes) where a block uses it, the ZeRO-3 pattern,
whose gradient DTensor's autograd reduce-scatters back onto the shards.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch


def axis_names(mesh) -> tuple:
    """A mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names``, or the
    ``axis_names`` of a reference-style mesh object."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(axis_names(mesh), tuple(shape)))


def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def make_rules(mesh, *, fsdp: bool = False, sp: bool = False) -> dict:
    """Logical axis -> mesh axis (or tuple of mesh axes), the reference's
    dict for the same axis names.  ``sp``: sequence-parallel residuals (seq
    over "model"), off in every cell, as the reference's."""
    b_axes = batch_axes(mesh)
    return {
        "batch": b_axes,
        # full data-parallel reshard (batch over every axis incl. model)
        "batch_all": b_axes + ("model",),
        "seq_shard": "model" if sp else None,
        "kv_seq": "model",
        "heads": "model",
        "kv_heads": "model",
        "heads_flat": "model",
        "d_ff": "model",
        "vocab": "model",
        "experts": "model",
        "d_model": "data" if fsdp else None,
        "layers": None,
        None: None,
    }


def axis_size(mesh, mesh_axes) -> int:
    if mesh_axes is None:
        return 1
    if isinstance(mesh_axes, str):
        mesh_axes = (mesh_axes,)
    sizes = axis_sizes(mesh)
    return int(math.prod(sizes[a] for a in mesh_axes))


def partition_spec(shape, logical_axes, mesh, rules: dict) -> tuple:
    """One entry per dim (None, a mesh axis, or a tuple of mesh axes),
    dropping non-divisible and already-used mesh axes, as the reference's."""
    used: set = set()
    parts = []
    for size, ax in zip(shape, logical_axes):
        mesh_ax = rules.get(ax)
        if mesh_ax is None:
            parts.append(None)
            continue
        axes_t = (mesh_ax,) if isinstance(mesh_ax, str) else tuple(mesh_ax)
        if any(a in used for a in axes_t) or size % axis_size(mesh, axes_t) != 0:
            parts.append(None)
            continue
        used.update(axes_t)
        parts.append(mesh_ax if isinstance(mesh_ax, str) else tuple(mesh_ax))
    return tuple(parts)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of a spec: per mesh dim, ``Shard(d)`` for the
    tensor dim ``d`` whose entry names that axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in axis_names(mesh):
        dim = next((d for d, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def spec_of(place, ndim: int, mesh) -> tuple:
    """The spec (one entry a dim) that ``place`` realises: the inverse of
    :func:`placements`."""
    by_dim: dict = {}
    for name, p in zip(axis_names(mesh), place):
        if p.is_shard():
            by_dim.setdefault(p.dim, []).append(name)
    return tuple(None if d not in by_dim else
                 (by_dim[d][0] if len(by_dim[d]) == 1 else tuple(by_dim[d]))
                 for d in range(ndim))


def sharding_for_spec(spec, mesh, rules: dict) -> tuple:
    """The placements of a :class:`ParamSpec` on ``mesh`` (the reference's
    ``NamedSharding``)."""
    return placements(partition_spec(spec.shape, spec.axes, mesh, rules), mesh)


def tree_shardings(spec_tree, mesh, rules: dict):
    """Placements tree matching a ParamSpec tree."""
    from repro_torch.zoo.configs.base import tree_map

    return tree_map(lambda s: None if s is None else sharding_for_spec(s, mesh, rules),
                    spec_tree)


# ---------------------------------------------------------------------------
# Activation-sharding context (model code is mesh-agnostic)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    mesh: object
    rules: dict


# a process-wide stack, not a context variable: autograd runs a CUDA
# backward (and the forward recompute of a checkpointed block) on a thread of
# its own, which has to see the context of the step that recorded the graph
_CTX: list = []


def current_ctx() -> Optional[ShardingCtx]:
    return _CTX[-1] if _CTX else None


@contextlib.contextmanager
def use_sharding(mesh, *, fsdp: bool = False, sp: bool = False):
    """Run model code sharded over ``mesh``: :func:`shard` constrains
    activations, plain tensors created inside (positions, masks) join the
    DTensors as replicated (``implicit_replication``)."""
    if mesh is None:
        yield None
        return
    from torch.distributed.tensor.experimental import implicit_replication

    ctx = ShardingCtx(mesh, make_rules(mesh, fsdp=fsdp, sp=sp))
    _CTX.append(ctx)
    try:
        with implicit_replication():
            yield ctx
    finally:
        _CTX.remove(ctx)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def as_dtensor(x: torch.Tensor, mesh, place) -> torch.Tensor:
    """A tensor every rank holds alike, as a DTensor with ``place``
    (replicated, then each rank keeps its own chunk: no communication)."""
    from torch.distributed.tensor import DTensor, Replicate

    if is_dtensor(x):
        return x.redistribute(mesh, place)
    rep = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return rep.redistribute(mesh, place)


def shard(x: torch.Tensor, logical_axes: tuple) -> torch.Tensor:
    """Constrain an activation's sharding by logical axes, and its
    gradient's to the same placements (``with_sharding_constraint``
    transposes to the same constraint on the cotangent: a partial-sum
    gradient is reduced here, not carried on to make a later matmul gather
    its weight); ``x`` itself without an active :func:`use_sharding`
    context."""
    ctx = current_ctx()
    if ctx is None:
        return x
    place = placements(partition_spec(x.shape, logical_axes, ctx.mesh, ctx.rules), ctx.mesh)
    if not (is_dtensor(x) and tuple(x.placements) == place):
        x = as_dtensor(x, ctx.mesh, place)
    return _pin_grad(x) if x.requires_grad else x


def _pin_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` unchanged, its gradient redistributed to ``x``'s placements."""
    from torch.distributed.tensor import DTensor

    place = tuple(x.placements)
    return DTensor.from_local(x.to_local(grad_placements=place), x.device_mesh, place,
                              run_check=False, shape=x.shape, stride=x.stride())


def zeros(shape, logical_axes: tuple, *, dtype, device=None) -> torch.Tensor:
    """``torch.zeros(shape)``, born sharded by ``logical_axes`` under a
    context (each rank allocates its own shard only)."""
    ctx = current_ctx()
    if ctx is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor

    place = placements(partition_spec(shape, logical_axes, ctx.mesh, ctx.rules), ctx.mesh)
    local = list(shape)
    for size, p in zip(axis_sizes(ctx.mesh).values(), place):
        if p.is_shard():
            local[p.dim] //= size
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device), ctx.mesh, place,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _gather_one(x):
    from torch.distributed.tensor import Replicate

    ctx = current_ctx()
    if ctx is None or not is_dtensor(x):
        return x
    b_axes = batch_axes(ctx.mesh)
    place = tuple(Replicate() if name in b_axes else p
                  for name, p in zip(axis_names(ctx.mesh), x.placements))
    return x if place == tuple(x.placements) else x.redistribute(ctx.mesh, place)


def gather_params(tree):
    """The params of one block as it uses them: each DTensor leaf with its
    FSDP shards (placements over the batch axes) all-gathered; ``tree``
    itself without a context."""
    if current_ctx() is None:
        return tree
    from repro_torch.zoo.configs.base import tree_map

    return tree_map(lambda a: None if a is None else _gather_one(a), tree)


def microbatch(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n`` along dim 0: rows [i b/n, (i + 1) b/n), or,
    for a DTensor split along dim 0, that slice of each rank's own rows (a
    partition of the batch as good as the other for gradient accumulation,
    with no rows moved between ranks)."""
    if not is_dtensor(x) or not any(p.is_shard(0) for p in x.placements) \
            or x.to_local().shape[0] % n:
        m = x.shape[0] // n
        return x[i * m:(i + 1) * m]
    from torch.distributed.tensor import DTensor

    local = x.to_local()
    m = local.shape[0] // n
    shape = (x.shape[0] // n,) + tuple(x.shape[1:])
    return DTensor.from_local(local[i * m:(i + 1) * m], x.device_mesh, x.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def batch_local(fn, x: torch.Tensor, params, *state):
    """``fn(x, params, *state) -> (y, new_state)`` on each rank's rows of
    the batch, with every param gathered whole: the data-parallel form of a
    block whose ops the sharding rules do not split (the RWKV and RG-LRU
    recurrences).  ``x`` and the state leaves are split along dim 0 over
    the batch axes (where they divide it) and replicated over the rest, as
    are ``y`` and the new state; a param's gradient sums over the batch
    axes.  Without a context (or on plain tensors) this is ``fn`` itself."""
    ctx = current_ctx()
    if ctx is None or not is_dtensor(x):
        return fn(x, params, *state)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.zoo.configs.base import leaves, tree_map, unflatten

    mesh = ctx.mesh
    b_axes = batch_axes(mesh)
    split = x.shape[0] % axis_size(mesh, b_axes) == 0
    names = axis_names(mesh)
    rows = tuple(Shard(0) if split and n in b_axes else Replicate() for n in names)
    rep = tuple(Replicate() for _ in names)
    grad = tuple(Partial() if split and n in b_axes else Replicate() for n in names)

    def local(t, place, grad_place):
        if t is None:
            return None
        t = as_dtensor(t, mesh, place)
        return t.to_local(grad_placements=grad_place if t.requires_grad else None)

    p_flat = [local(t, rep, grad) for t in leaves(params)]
    st = tree_map(lambda t: local(t, rows, rows), state)
    y, new_state = fn(local(x, rows, rows), unflatten(params, p_flat), *st)
    wrap = lambda t: None if t is None else DTensor.from_local(  # noqa: E731
        t, mesh, rows, run_check=False)
    return wrap(y), tree_map(wrap, new_state)


def local_range(x, dim: int) -> tuple:
    """(local size, global offset) of this rank's slice of DTensor ``x``
    along ``dim``."""
    size, offset = x.shape[dim], 0
    coord = x.device_mesh.get_coordinate()
    for i, p in enumerate(x.placements):  # mesh order: the major split first
        if p.is_shard(dim):
            size = -(-size // x.device_mesh.size(i))
            offset += coord[i] * size
    return size, offset


def mesh_index(name: str) -> int:
    """This rank's coordinate along mesh axis ``name`` (0 without a
    context)."""
    ctx = current_ctx()
    if ctx is None:
        return 0
    return int(ctx.mesh.get_coordinate()[axis_names(ctx.mesh).index(name)])
