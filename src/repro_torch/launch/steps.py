"""Step builders + sharding assignments for the launcher and the dry run
(port of ``repro/launch/steps.py``).

For every (arch, shape) cell this module produces:
  * the step function (train_step / prefill_step / serve_step),
  * abstract input trees (meta tensors: shape and dtype, no storage),
  * in/out shardings (DTensor placement trees from the logical rules).

Memory plans (the reference's):
  * params are stored f32 (the fp32 master) and cast to bf16 at use;
  * train cells shard params/grads/opt-state over BOTH mesh axes
    (TP over "model" + FSDP over "data");
  * the 235B/400B archs use int8 blockwise Adam moments (AdamW8bit);
  * serve cells hold bf16 weights; TP-only for <=11B dense archs,
    TP+FSDP for the giants.

The port's steps run eagerly, so a cell also says how its abstract inputs
become the step's arguments (:attr:`Cell.prepare`): the training form's
``nn.Parameter`` masters, the serving form's per-layer :class:`ParamDict`.
``launch/dryrun.py:run_cell`` materialises the inputs as fake DTensors on
the mesh and runs the step under the counter.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.sharding.rules import (
    axis_names,
    batch_axes,
    make_rules,
    partition_spec,
    placements,
    tree_shardings,
)
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.train_step import make_train_step
from repro_torch.zoo.configs.base import (
    ModelConfig,
    abstract,
    leaves,
    model_spec_tree,
    param_tree,
    tree_map,
)
from repro_torch.zoo.configs.shapes import SHAPES, ShapeSpec, input_specs
from repro_torch.zoo.models.attention import KVCache
from repro_torch.zoo.models.transformer import ParamDict, init_cache_tree
from repro_torch.zoo.serving.decode import make_prefill_step, make_serve_step

INT8_OPT_ARCHS = {"llama4-maverick-400b-a17b", "qwen3-moe-235b-a22b"}
# sequence-parallel residuals: off everywhere (measured in the reference:
# SP regressed collectives on every arch)
SP_TRAIN_ARCHS = set()
FSDP_SERVE_ARCHS = {
    "deepseek-67b", "llama4-maverick-400b-a17b", "qwen3-moe-235b-a22b",
}
# train_4k grad-accumulation per arch.  Each microbatch re-gathers the
# FSDP weight shards (all-gather per layer), so fewer microbatches directly
# divides the collective term.
MICROBATCHES = {
    "default": 8,
    "deepseek-67b": 8,
    "llama4-maverick-400b-a17b": 4,
    "qwen3-moe-235b-a22b": 4,
}
# grouped remat (checkpoint over groups of super-blocks): residual saved
# once per G super-blocks -> sqrt(L)-ish saved-activation memory
REMAT_GROUP = {
    "default": 1,
    "deepseek-67b": 10,          # n_super=95 -> 9 groups + tail 5
    "llama4-maverick-400b-a17b": 6,   # n_super=24
    "qwen3-moe-235b-a22b": 10,   # n_super=94 -> 9 groups + tail 4
}


def _batch_sharding(mesh, shape) -> tuple:
    """Shard dim 0 over the batch mesh axes when divisible."""
    axes = batch_axes(mesh)
    size = int(np.prod([dict(zip(axis_names(mesh), mesh.shape))[a] for a in axes]))
    spec = [None] * len(shape)
    if shape[0] % size == 0:
        spec[0] = axes if len(axes) > 1 else axes[0]
    return placements(tuple(spec), mesh)


def _replicated(mesh) -> tuple:
    return placements((), mesh)


# ---------------------------------------------------------------------------
# Cache shardings (keyed by the leaf's name)
# ---------------------------------------------------------------------------

_CACHE_AXES = {
    "k": ("batch", "kv_seq", None, None),
    "v": ("batch", "kv_seq", None, None),
    "ck": ("batch", None, None, None),
    "cv": ("batch", None, None, None),
    "s": ("batch", None, None, None),       # rwkv state
    "x_prev": ("batch", None),
    "ffn_prev": ("batch", None),
    "h": ("batch", None),                   # rglru state
    "conv": ("batch", None, None),
}


def cache_shardings(cache, mesh, rules: dict):
    """Placements for the port's cache (one dict per layer; ``KVCache``
    leaves ``k``/``v``), by the reference's path-keyed logical axes."""
    def leaf(name, x):
        axes = tuple(_CACHE_AXES.get(name, ()))
        if len(axes) != x.dim():
            axes = (None,) * x.dim()
        return placements(partition_spec(x.shape, axes, mesh, rules), mesh)

    def walk(node, name=None):
        if isinstance(node, KVCache):
            return KVCache(leaf("k", node.k), leaf("v", node.v), node.pos, node.window)
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        return leaf(name, node)

    return walk(cache)


# ---------------------------------------------------------------------------
# Optimizer-state shardings
# ---------------------------------------------------------------------------

def opt_state_shardings(opt_state, param_shardings: list, mesh) -> opt_mod.AdamWState:
    """m/v like the params (Q8 moments are parameter-shaped, so the q
    tensor takes the param's placements verbatim and the (..., 1) scale
    takes them minus a split of the last dim); step replicated."""
    from torch.distributed.tensor import Replicate

    def per_leaf(z, psh):
        if isinstance(z, opt_mod.Q8):
            last = z.q.dim() - 1
            scale = tuple(Replicate() if p.is_shard(last) else p for p in psh)
            return opt_mod.Q8(q=tuple(psh), scale=scale)
        return tuple(psh)

    return opt_mod.AdamWState(
        step=_replicated(mesh),
        m=[per_leaf(z, p) for z, p in zip(opt_state.m, param_shardings)],
        v=[per_leaf(z, p) for z, p in zip(opt_state.v, param_shardings)],
    )


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    step_fn: Any
    args: tuple            # abstract inputs (meta tensors)
    in_shardings: tuple    # placements trees, as ``args``
    out_shardings: Any     # placements trees of the outputs (None: as they come)
    donate_argnums: tuple = ()
    static_meta: dict = dataclasses.field(default_factory=dict)
    # materialised args -> the step's arguments
    prepare: Optional[Callable] = None


def make_optimizer(arch: str):
    if arch in INT8_OPT_ARCHS:
        return opt_mod.AdamW8bit(lr=3e-4, weight_decay=0.1)
    return opt_mod.AdamW(lr=3e-4, weight_decay=0.1)


def _trainable(params):
    return tree_map(lambda a: None if a is None else nn.Parameter(a), params)


def serving_tree(cfg: ModelConfig) -> dict:
    """The serving form's spec tree: per-layer (unstacked) specs, the
    layout of :class:`ParamDict`."""
    tree = param_tree(cfg)
    return {k: v for k, v in tree.items() if v is not None}


def build_cell(cfg: ModelConfig, shape_name: str, mesh, *,
               microbatches: Optional[int] = None, spec: Optional[ShapeSpec] = None,
               max_seq: Optional[int] = None) -> Cell:
    """The cell of (cfg, shape) on ``mesh``.  For the dry run's cut traces
    and the card's checks of it, three overrides: ``spec`` a shape of its
    own in place of ``SHAPES[shape_name]``, ``microbatches`` (train cells)
    the microbatch count, ``max_seq`` (prefill cells) the cache length in
    place of the shape's sequence."""
    sh = spec or SHAPES[shape_name]
    spec_tree = model_spec_tree(cfg)
    rules_fsdp = make_rules(mesh, fsdp=True)
    rules_tp = make_rules(mesh, fsdp=False)
    specs = input_specs(cfg, shape_name, spec=spec)

    if sh.kind == "train":
        params_avals = abstract(spec_tree, torch.float32)
        p_shard = tree_shardings(spec_tree, mesh, rules_fsdp)
        optimizer = make_optimizer(cfg.name)
        opt_avals = optimizer.init(leaves(params_avals))
        o_shard = opt_state_shardings(opt_avals, _leaf_placements(p_shard), mesh)
        mb = MICROBATCHES.get(cfg.name, MICROBATCHES["default"])
        rg = REMAT_GROUP.get(cfg.name, REMAT_GROUP["default"])
        mb = microbatches or mb
        step = make_train_step(cfg, optimizer, microbatches=mb, remat=True, remat_group=rg)
        batch = {"tokens": specs["tokens"]}
        b_shard = {"tokens": _batch_sharding(mesh, specs["tokens"].shape)}
        if "enc_input" in specs:
            batch["enc_input"] = specs["enc_input"]
            b_shard["enc_input"] = _batch_sharding(mesh, specs["enc_input"].shape)

        def fn(params, opt_state, batch):
            return step(params, opt_state, batch)

        rep = _replicated(mesh)
        return Cell(
            arch=cfg.name, shape=sh.name, step_fn=fn,
            args=(params_avals, opt_avals, batch),
            in_shardings=(p_shard, o_shard, b_shard),
            out_shardings=(p_shard, o_shard, {"loss": rep, "grad_norm": rep}),
            donate_argnums=(0, 1),
            static_meta={"microbatches": mb, "optimizer": type(optimizer).__name__,
                         "fsdp": True, "sp": cfg.name in SP_TRAIN_ARCHS,
                         "remat_group": rg},
            prepare=lambda params, opt_state, batch: (_trainable(params), opt_state, batch),
        )

    # serving cells: bf16 weights, the per-layer serving form
    fsdp = cfg.name in FSDP_SERVE_ARCHS
    rules = rules_fsdp if fsdp else rules_tp
    s_tree = serving_tree(cfg)
    dtype = getattr(torch, cfg.dtype)
    params_avals = tree_map(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"), s_tree)
    p_shard = tree_shardings(s_tree, mesh, rules)

    if sh.kind == "prefill":
        step = make_prefill_step(cfg, max_seq or sh.seq_len)
        args = [params_avals, specs["tokens"]]
        in_sh = [p_shard, _batch_sharding(mesh, specs["tokens"].shape)]
        if "enc_input" in specs:
            args.append(specs["enc_input"])
            in_sh.append(_batch_sharding(mesh, specs["enc_input"].shape))
        cache_avals = init_cache_tree(cfg, sh.global_batch, max_seq or sh.seq_len,
                                      device="meta")
        out_sh = (
            _batch_sharding(mesh, (sh.global_batch, cfg.padded_vocab)),
            cache_shardings(cache_avals, mesh, rules),
        )
        return Cell(
            arch=cfg.name, shape=sh.name, step_fn=step,
            args=tuple(args), in_shardings=tuple(in_sh), out_shardings=out_sh,
            static_meta={"fsdp": fsdp},
            prepare=lambda params, *rest: (ParamDict(params), *rest),
        )

    # decode
    step = make_serve_step(cfg)
    cache_avals = specs["cache"]
    c_shard = cache_shardings(cache_avals, mesh, rules)
    tok_sh = _batch_sharding(mesh, specs["token"].shape)
    out_sh = (
        tok_sh,
        _batch_sharding(mesh, (sh.global_batch, cfg.padded_vocab)),
        c_shard,
    )
    return Cell(
        arch=cfg.name, shape=sh.name, step_fn=step,
        args=(params_avals, cache_avals, specs["token"]),
        in_shardings=(p_shard, c_shard, tok_sh),
        out_shardings=out_sh,
        donate_argnums=(1,),
        static_meta={"fsdp": fsdp},
        prepare=lambda params, cache, token: (ParamDict(params), cache, token),
    )


def _leaf_placements(tree) -> list:
    """The placements of a placements tree, in :func:`leaves` order (a
    placements tuple is one leaf)."""
    out: list = []

    def walk(node):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list):
            for x in node:
                walk(x)
        else:
            out.append(node)

    walk(tree)
    return out


# ---------------------------------------------------------------------------
# GROOT GNN cell (the paper's own architecture, 11th arch)
# ---------------------------------------------------------------------------

GROOT_SHAPES = {
    # name: (bits, batch) — node/edge counts follow the paper's table
    # (1024-bit CSA x batch 16 = 134,103,040 nodes / 268,140,544 edges).
    "verify_256b_bs16": (256, 16),
    "verify_1024b_bs16": (1024, 16),
}


def groot_graph_dims(bits: int, batch: int, num_partitions: int):
    """Padded per-partition sizes.  CSA node/edge counts scale ~ 6*bits^2
    (paper: 1024b x16 -> 134.1M nodes, 268.1M edges => 8.186M/16.37M per
    design).  Halo re-growth adds ~10% (paper §III-C) + padding slack."""
    nodes = int(8.0 * bits * bits * batch)
    edges = 2 * nodes
    n_per = nodes // num_partitions
    e_per = edges // num_partitions
    pad = lambda x: int(np.ceil(x * 1.3 / 1024.0)) * 1024  # noqa: E731  halo + slack
    return pad(n_per), pad(e_per)


def groot_infer_step(cfg, n_sub: int):
    """The GNN cell's step on ``{name: tensor}`` params (a
    :class:`GrootGNN`'s ``named_parameters``): each partition's logits by
    the segment-sum forward in bf16 (the reference's ``vmap`` over the
    leading partition axis, a loop here), argmax, -1 outside the core."""
    from repro_torch.core import gnn

    bf16 = torch.bfloat16

    def one(params16, x, es, ed, ei, sl, mask):
        logits = gnn.forward(params16, x, es, ed, ei.to(bf16) > 0.5, sl.to(bf16),
                             num_nodes=n_sub)
        pred = logits.argmax(-1).to(torch.int32)
        return torch.where(mask, pred, -1)

    def infer_step(params, batch):
        params16 = _groot_model(cfg, {k: v.to(bf16) for k, v in params.items()})
        return torch.stack([one(params16, *(batch[k][i] for k in GROOT_BATCH_KEYS))
                            for i in range(batch["x"].shape[0])])

    return infer_step


GROOT_BATCH_KEYS = ("x", "edge_src", "edge_dst", "edge_inv", "edge_slot", "core_mask")


def build_groot_cell(gcfg, shape_name: str, mesh) -> Cell:
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.core import gnn

    bits, batch = GROOT_SHAPES[shape_name]
    n_dev = int(np.prod(tuple(mesh.shape)))
    parts = n_dev  # one re-grown partition per device
    n_sub, e_sub = groot_graph_dims(bits, batch, parts)
    cfg = gcfg.gnn

    with torch.device("meta"):
        model = gnn.GrootGNN(cfg)
    params_avals = {k: v.detach() for k, v in model.named_parameters()}
    i32, bf16 = torch.int32, torch.bfloat16  # bf16 inference: halves the SpMM's bytes
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")  # noqa: E731
    batch_avals = {
        "x": meta((parts, n_sub, cfg.in_features), bf16),
        "edge_src": meta((parts, e_sub), i32),
        "edge_dst": meta((parts, e_sub), i32),
        "edge_inv": meta((parts, e_sub), torch.bool),
        "edge_slot": meta((parts, e_sub), torch.uint8),
        "core_mask": meta((parts, n_sub), torch.bool),
    }
    all_axes = tuple(axis_names(mesh))
    part = placements((all_axes,), mesh)  # the partition axis over every mesh axis
    b_shard = {k: part for k in batch_avals}
    rep = _replicated(mesh)
    step = groot_infer_step(cfg, n_sub)

    def infer_step(params, batch):
        """Each rank runs its own partitions (``local_map``): no collective."""
        names = sorted(params)

        def local(*flat):
            return step(dict(zip(names, flat[:len(names)])),
                        dict(zip(GROOT_BATCH_KEYS, flat[len(names):])))

        fn = local_map(local, out_placements=list(part),
                       in_placements=tuple([list(rep)] * len(names)
                                           + [list(part)] * len(GROOT_BATCH_KEYS)),
                       device_mesh=mesh)
        return fn(*(params[k] for k in names), *(batch[k] for k in GROOT_BATCH_KEYS))

    return Cell(
        arch="groot-gnn", shape=shape_name, step_fn=infer_step,
        args=(params_avals, batch_avals),
        in_shardings=({k: rep for k in params_avals}, b_shard),
        out_shardings=part,
        static_meta={"bits": bits, "batch": batch, "partitions": parts,
                     "nodes_per_part": n_sub, "edges_per_part": e_sub},
    )


def _groot_model(cfg, flat: dict):
    """A :class:`GrootGNN` holding the given tensors (named as its
    ``named_parameters``)."""
    from repro_torch.core import gnn

    with torch.device("meta"):
        model = gnn.GrootGNN(cfg)
    for name, t in flat.items():
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        setattr(mod, attr, nn.Parameter(t, requires_grad=False))
    return model

