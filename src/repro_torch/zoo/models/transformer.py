"""The LM stack (port of ``repro/zoo/models/transformer.py``): attention
(``global``, ``local``, ``cross+global``), RWKV6 (``rwkv``) and RG-LRU
(``rglru``) layers with a dense or MoE FFN, per the config's layer pattern
(a config's ``dense_layers`` leading layers dense), and the whisper encoder.
The port-only options: sandwich norms (a layer's ``ln1_post``/``ln2_post``
norm each block's output before the residual add) and the embedding scale
of untied models (``cfg.embed_scale``).

Entry points
------------
``model_forward(params, cfg, tokens, ...)``
    (B, S) tokens -> (B, S, V) logits; optionally threads a per-layer cache
    list (prefill/decode: ``decode=True`` is S == 1 against the cache) and
    takes the encoder input of the cross-attention archs (``enc_input``).
    ``remat`` checkpoints each super-block (``torch.utils.checkpoint``) and
    ``remat_group > 1`` each group of that many super-blocks, as the
    reference's ``jax.checkpoint`` does; neither changes a value.

``init_cache_tree(cfg, batch, max_seq)``
    the per-layer cache list.

``params_from_numpy(tree, cfg, device)``
    the weights bridge: the reference's materialised tree (or the port's own
    :func:`~repro_torch.zoo.configs.base.materialize` output) -> the serving
    form, an :class:`nn.Module` of per-layer weights cast to ``cfg.dtype``;
    with ``trainable=True`` -> the training form, the reference's stacked
    tree of f32 ``nn.Parameter`` leaves.

``params_to_numpy(params, cfg)``
    the inverse bridge: either form -> the reference's stacked tree as numpy
    arrays (the layout checkpoints are written in).

Two forms of the params:
  * **serving** (:class:`ParamDict`): per-layer weights, frozen, cast to
    ``cfg.dtype`` once when loaded, where the reference casts them per block
    at every call (the cast values are the same);
  * **training** (a plain dict in the reference's layout: ``blocks`` with a
    leading super-block axis, ``tail``, ``embed``, ...): the reference's
    fp32-master scheme.  The leaves stay f32 and are cast to ``cfg.dtype``
    at the reference's points: ``embed``, ``final_norm``, ``lm_head``,
    ``encoder`` and ``tail`` up front, each super-block's params when the
    block runs (inside its checkpoint under remat), so gradients arrive in
    f32 through the cast, as JAX's do through ``astype``.

Departures from the reference, none of which changes a value:
  * the layers run in a Python loop, not a scan; the stacked leaves of the
    training form are unbound along their super-block axis once a forward;
  * where the reference's ``jnp`` ops promote a bf16 activation against f32
    weights (an encoder input in bf16 beside an f32 model), the port casts
    the activation up first, which is what the promotion computes;
  * remat applies to calls without a cache (the reference checkpoints cached
    calls too, which only matters under grad).

Under a sharding context (``repro_torch.sharding.use_sharding``) the params
are DTensors placed by ``tree_shardings``; the residual stream, the caches
and the logits are constrained at the reference's ``shard()`` points, and
each block's params are all-gathered over their FSDP axes where the block
uses them (``sharding.rules.gather_params``: cast first, so the gather moves
``cfg.dtype``), where the reference leaves that gather to GSPMD.  Without a
context every such point is the identity.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.sharding import rules as sh
from repro_torch.sharding.rules import shard
from repro_torch.zoo.configs.base import ModelConfig, leaves, stack_layers, tree_map, unflatten
from repro_torch.zoo.models import rglru as rglru_mod
from repro_torch.zoo.models import rwkv6
from repro_torch.zoo.models.attention import (
    attention,
    cross_attention,
    encode_cross_kv,
    init_cache,
)
from repro_torch.zoo.models.layers import mlp, rms_norm, softcap
from repro_torch.zoo.models.moe import moe_apply


class ParamDict(nn.Module):
    """A nested dict of weights held as an ``nn.Module``: ``p["wq"]``,
    ``"bq" in p``; a list value becomes an ``nn.ModuleList``
    of ``ParamDict``s.  Weights are frozen (inference only)."""

    def __init__(self, tree: dict):
        super().__init__()
        for key in sorted(tree):
            val = tree[key]
            if isinstance(val, dict):
                self.add_module(key, ParamDict(val))
            elif isinstance(val, list):
                self.add_module(key, nn.ModuleList(ParamDict(x) for x in val))
            else:
                self.register_parameter(key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None, *, trainable: bool = False):
    """The port's weights from a materialised param tree: numpy arrays (the
    reference's ``materialize`` output through ``np.asarray``) or tensors.

    Takes the stacked layout (``blocks``: per position of the layer pattern,
    leaves with a leading super-block axis, plus ``tail``) or a per-depth
    ``layers`` list.

    Serving form (the default): a :class:`ParamDict` with ``embed``,
    ``final_norm``, ``lm_head`` (untied models), ``encoder`` (whisper: its
    per-depth ``layers``, ``final_norm``, ``pos_embed``) and ``layers``, one
    :class:`ParamDict` per depth (nested dicts such as RWKV's ``mu`` and the
    ``(E, d, f)`` expert leaves kept as they are); f32 leaves are cast to
    ``cfg.dtype`` once.

    Training form (``trainable=True``): the reference's stacked tree (a
    per-depth one is stacked by :func:`stack_layers`) as a plain dict whose leaves are
    ``nn.Parameter``s in the tree's own dtype (f32 masters), requiring grad;
    :func:`model_forward` casts them at use.  Its :func:`leaves` are in the
    reference's flatten order.
    """
    device = resolve_device(device)
    if trainable:
        tree = stack_layers(cfg, tree) if "layers" in tree else tree
        blocks = tree.get("blocks") or []
        n = (leaves(blocks[0])[0].shape[0] * len(blocks) if blocks else 0) + len(
            tree.get("tail") or [])
        if n != cfg.num_layers:
            raise ValueError(f"{cfg.name}: {n} layers in the tree, config has {cfg.num_layers}")

        def master(a):  # a copy of its own: the train step updates it in place
            t = a.to(device, copy=True) if isinstance(a, torch.Tensor) else torch.tensor(
                a, device=device)
            return nn.Parameter(t)

        return tree_map(lambda a: None if a is None else master(a), tree)
    dtype = getattr(torch, cfg.dtype)

    def load(a):  # tensors of the training form are detached: serving keeps no graph
        t = torch.as_tensor(a).detach().to(device)
        return t.to(dtype) if t.dtype == torch.float32 else t

    if "layers" in tree:
        layers = [tree_map(load, lp) for lp in tree["layers"]]
    else:
        layers = []
        blocks = tree.get("blocks")
        if blocks is not None:
            blocks = [tree_map(load, b) for b in blocks]
            n_super = leaves(blocks[0])[0].shape[0]
            # super-block j holds layers [j * period + t for t in range(period)]
            layers = [tree_map(lambda a, j=j: a[j], blocks[t])
                      for j in range(n_super) for t in range(len(blocks))]
        layers += [tree_map(load, lp) for lp in tree.get("tail") or []]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"{cfg.name}: {len(layers)} layers in the tree, config has "
                         f"{cfg.num_layers}")
    top = {k: load(tree[k]) for k in ("embed", "final_norm", "lm_head") if tree.get(k) is not None}
    if cfg.encoder_layers:
        top["encoder"] = tree_map(load, tree["encoder"])
    return ParamDict({**top, "layers": layers})


def _as_tree(p):
    """A :class:`ParamDict` as nested dicts and lists of its tensors."""
    if isinstance(p, nn.ModuleList):
        return [_as_tree(m) for m in p]
    return {**{k: v for k, v in p._parameters.items()},
            **{k: _as_tree(m) for k, m in p._modules.items()}}


def params_to_numpy(params, cfg: ModelConfig) -> dict:
    """The inverse bridge: the serving form (:class:`ParamDict`) or the
    training form -> the reference's stacked tree (``blocks`` with a leading
    super-block axis, ``tail``, ``embed``, ...) as numpy arrays, the layout
    :func:`params_from_numpy` takes back.  bf16 leaves come back as f32
    arrays, exactly (numpy has no bf16)."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    if isinstance(params, ParamDict):
        params = stack_layers(cfg, _as_tree(params))
    return tree_map(lambda t: None if t is None else host(t), params)


# ---------------------------------------------------------------------------
# Per-layer application
# ---------------------------------------------------------------------------

def apply_layer(x: torch.Tensor, lp, cfg: ModelConfig, kind: str, is_moe: bool,
                cache: Optional[dict], enc_out: Optional[torch.Tensor] = None,
                decode: bool = False):
    """One residual layer.  Returns (x, new_cache_entry)."""
    new_cache: dict = {}
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if kind in ("global", "local"):
        window = cfg.sliding_window if kind == "local" else 0
        kv_cache = cache.get("kv") if cache else None
        out, nc = attention(h, lp["attn"], cfg, window=window, cache=kv_cache,
                            rotary=kind == "local" or not cfg.rope_local_only)
        if nc is not None:
            new_cache["kv"] = nc
    elif kind == "cross+global":
        kv_cache = cache.get("kv") if cache else None
        out, nc = attention(h, lp["attn"], cfg, cache=kv_cache)
        if nc is not None:
            new_cache["kv"] = nc
        x = x + out.to(x.dtype)
        h = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
        if cache is not None and decode:
            ckv = (cache["ck"], cache["cv"])
        else:
            ckv = encode_cross_kv(enc_out, lp["cross"], cfg)
        if cache is not None:
            new_cache["ck"], new_cache["cv"] = ckv
        out = cross_attention(h, ckv, lp["cross"], cfg)
    elif kind == "rwkv":
        st = cache.get("mix") if cache else None
        if decode or rwkv6.FORCE_SCAN or (st is not None and x.shape[1] <= 4):
            mix = rwkv6.time_mix_scan
        else:
            mix = rwkv6.time_mix_chunked
        out, ns = sh.batch_local(lambda x, p, s: mix(x, p, cfg, s), h, lp["rwkv"], st)
        if cache is not None:
            new_cache["mix"] = ns
    elif kind == "rglru":
        st = cache.get("rec") if cache else None
        out, ns = sh.batch_local(
            lambda x, p, s: rglru_mod.rglru_block(x, p, cfg, s, decode=decode), h, lp["rglru"], st)
        if cache is not None:
            new_cache["rec"] = ns
    else:
        raise ValueError(kind)
    if "ln1_post" in lp:  # sandwich norms: each block's output normed too
        out = rms_norm(out, lp["ln1_post"], cfg.norm_eps)
    x = x + out.to(x.dtype)
    x = shard(x, ("batch", "seq_shard", None))

    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if is_moe:
        out = moe_apply(h, lp["moe"], cfg)
    elif kind == "rwkv":
        prev = cache.get("ffn_prev") if cache else None
        out, carry = sh.batch_local(rwkv6.channel_mix, h, lp["ffn"], prev)
        if cache is not None:
            new_cache["ffn_prev"] = carry
    else:
        out = mlp(h, lp["ffn"], cfg.act)
    if "ln2_post" in lp:
        out = rms_norm(out, lp["ln2_post"], cfg.norm_eps)
    x = x + out.to(x.dtype)
    return shard(x, ("batch", "seq_shard", None)), new_cache


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def _layer_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int, dtype, device):
    c: dict[str, Any] = {}
    if kind in ("global", "local", "cross+global"):
        window = cfg.sliding_window if kind == "local" else 0
        window = min(window, max_seq) if window else 0
        c["kv"] = init_cache(cfg, batch, max_seq, window=window, dtype=dtype, device=device)
    if kind == "cross+global":
        kv, hd = cfg.num_kv_heads, cfg.head_dim_
        enc_s = cfg.encoder_seq or cfg.cross_seq
        axes = ("batch", None, None, None)
        c["ck"] = sh.zeros((batch, enc_s, kv, hd), axes, dtype=dtype, device=device)
        c["cv"] = sh.zeros((batch, enc_s, kv, hd), axes, dtype=dtype, device=device)
    if kind == "rwkv":
        st = rwkv6.init_state(cfg, batch, device)
        c["mix"] = {"s": st["s"], "x_prev": st["x_prev"]}
        c["ffn_prev"] = st["ffn_prev"]
    if kind == "rglru":
        c["rec"] = rglru_mod.init_state(cfg, batch, device)
    return c


def init_cache_tree(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
                    device=None) -> list:
    """One cache dict per layer (the reference stacks them per super-block
    for its scan).  The recurrent states keep the reference's dtypes (f32
    state, bf16 carries) whatever ``dtype`` is."""
    return [_layer_cache(cfg, kind, batch, max_seq, dtype, device) for kind in cfg.layer_kinds()]


# ---------------------------------------------------------------------------
# Encoder (whisper)
# ---------------------------------------------------------------------------

def run_encoder(enc_params, enc_input: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Bidirectional encoder over stub frontend embeddings (B, S_enc, D).
    The residual stream keeps ``enc_input``'s dtype, as the reference's."""
    ct = torch.promote_types(enc_input.dtype, enc_params["final_norm"].dtype)
    x = enc_input + enc_params["pos_embed"][None, : enc_input.shape[1]].to(enc_input.dtype)
    for lp in enc_params["layers"]:
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        out, _ = attention(h.to(ct), lp["attn"], cfg, bidirectional=True)
        x = x + out.to(x.dtype)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp(h.to(ct), lp["ffn"], cfg.act).to(x.dtype)
    return rms_norm(x, enc_params["final_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings.  Over a vocab-sharded DTensor table each rank
    looks up the tokens in its slice of the vocabulary (zeros elsewhere)
    and the partial rows sum over the ranks that split it."""
    if not sh.is_dtensor(table):
        return table[tokens.long()]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    n, lo = sh.local_range(table, 0)
    tp = tuple(table.placements)
    b_ok = tokens.shape[0] % sh.axis_size(mesh, sh.batch_axes(mesh)) == 0
    tok = [Shard(0) if b_ok and name in sh.batch_axes(mesh) else Replicate()
           for name in sh.axis_names(mesh)]
    out = [Partial() if p == Shard(0) else t for p, t in zip(tp, tok)]
    grad = [p if p == Shard(0) else (Partial() if t == Shard(0) else Replicate())
            for p, t in zip(tp, tok)]

    def local(tb, tk):
        idx = tk.long() - lo
        ok = ((idx >= 0) & (idx < n))[..., None]
        rows = tb[idx.clamp(0, n - 1)]
        return torch.where(ok, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))

    fn = local_map(local, out_placements=out, in_placements=(list(tp), tok),
                   in_grad_placements=(grad, tok), device_mesh=mesh, redistribute_inputs=True)
    return fn(table, tokens)


def _cast(tree, dtype):
    """f32 leaves of ``tree`` cast to ``dtype`` (the fp32-master cast)."""
    return tree_map(lambda a: a.to(dtype) if a.dtype == torch.float32 else a, tree)


def model_forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
                  enc_input: Optional[torch.Tensor] = None, cache: Optional[list] = None,
                  decode: bool = False, remat: bool = False, remat_group: int = 1,
                  last_only: bool = False):
    """tokens (B, S) -> logits (B, S, V).  Returns (logits, new_cache).

    ``params`` is either form of :func:`params_from_numpy`.  Without a
    cache, ``remat`` checkpoints each super-block of ``pattern_period``
    layers, and ``remat_group > 1`` checkpoints each group of that many
    super-blocks (the blocks inside checkpointed too under ``remat``), as
    the reference's scan-over-scan does; the remainder layers (``tail``)
    run unchecked, as the reference's."""
    kinds = cfg.layer_kinds()
    period = cfg.pattern_period
    n_super = cfg.num_layers // period if cfg.num_layers // period > 1 else 0
    dtype = getattr(torch, cfg.dtype)
    sharded = sh.current_ctx() is not None
    top_keys = ("embed", "final_norm", "lm_head", "encoder")
    if isinstance(params, ParamDict):  # serving: per-layer weights, cast at load
        top, cast = params, None
        layers = list(params["layers"])
        if sharded:  # each layer's FSDP shards gathered where it runs
            top = sh.gather_params({k: _as_tree(params[k]) if isinstance(params[k], nn.Module)
                                    else params[k] for k in top_keys if k in params})
            cast = lambda lp: sh.gather_params(_as_tree(lp))  # noqa: E731
        body = [layers[j * period:(j + 1) * period] for j in range(n_super)]
        tail = layers[n_super * period:]
        tail = tail if cast is None else [cast(lp) for lp in tail]
    else:  # training: f32 masters in the stacked layout, cast at use
        top = {k: sh.gather_params(_cast(params[k], dtype)) for k in top_keys
               if params.get(k) is not None}
        cast = lambda lp: sh.gather_params(_cast(lp, dtype))  # noqa: E731
        blocks = params.get("blocks") or []
        unbound = [[a.unbind(0) for a in leaves(b)] for b in blocks]
        body = [[unflatten(b, [u[j] for u in ub]) for b, ub in zip(blocks, unbound)]
                for j in range(n_super if blocks else 0)]
        tail = [cast(lp) for lp in params.get("tail") or []]
    x = _embed(top["embed"], tokens).to(dtype)
    if cfg.tie_embeddings or cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    x = shard(x, ("batch", "seq_shard", None))
    enc_out = None
    if cfg.encoder_layers and enc_input is not None:
        enc_out = run_encoder(top["encoder"], enc_input, cfg)
    elif cfg.cross_seq and enc_input is not None:
        enc_out = enc_input  # vlm: stub patch embeddings are the "encoder"
    new_cache = None if cache is None else []

    def layer(x, lp, i):
        x, nc = apply_layer(x, lp, cfg, kinds[i], cfg.is_moe_layer(i),
                            None if cache is None else cache[i], enc_out, decode)
        if cache is not None:
            new_cache.append(nc)
        return x

    def block(x, j):
        bp = body[j] if cast is None else [cast(lp) for lp in body[j]]  # per-block cast
        for t, lp in enumerate(bp):
            x = layer(x, lp, j * period + t)
        return x

    remat = remat and cache is None
    # no op of a block draws random numbers, so the recompute needs no saved
    # RNG state
    run_block = (lambda x, j: checkpoint(block, x, j, use_reentrant=False,
                                         preserve_rng_state=False)) if remat else block
    grouped = 0  # super-blocks run in checkpointed groups of remat_group
    if remat_group > 1 and cache is None and len(body) > 1:
        g = remat_group
        grouped = len(body) - len(body) % g

        def group(x, start):
            for j in range(start, start + g):
                x = run_block(x, j)
            return x

        for start in range(0, grouped, g):
            x = checkpoint(group, x, start, use_reentrant=False, preserve_rng_state=False)
    for j in range(grouped, len(body)):
        x = run_block(x, j)
    for i, lp in enumerate(tail):
        x = layer(x, lp, len(body) * period + i)
    if last_only:
        x = x[:, -1:]  # prefill: only the last position feeds the LM head
    x = rms_norm(x, top["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ top["embed"].to(x.dtype).T
    else:
        logits = x @ top["lm_head"]
    if cfg.final_softcap:
        logits = softcap(logits.float(), cfg.final_softcap)
    logits = shard(logits, ("batch", None, "vocab"))
    return logits, new_cache
