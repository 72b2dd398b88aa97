"""Model configuration and parameter specs (port of
``repro/zoo/configs/base.py``).

One :class:`ModelConfig` dataclass, field for field the reference's, drives
every LM architecture of the zoo; :class:`PortModelConfig` adds, as fields,
the options of the architectures only the port has (``PORT_ARCHS``), which
every other config reads as their "off" defaults.  Parameters are described
once as a tree
of :class:`ParamSpec` (shape + logical axes + init).  The port walks its own
spec trees (nested dicts and lists with ``ParamSpec`` leaves) and
materialises them from an explicit :class:`torch.Generator`, or stands
them in by shape and dtype alone (:func:`abstract`, meta tensors: the dry
run's ``ShapeDtypeStruct``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | audio | vlm | hybrid | gnn
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # attention options
    qk_norm: bool = False            # qwen3
    qkv_bias: bool = False           # qwen2
    attn_softcap: Optional[float] = None    # gemma2 attention logit softcap
    final_softcap: Optional[float] = None   # gemma2 final logit softcap
    sliding_window: int = 0          # local-attention window (0 = none)
    rope_theta: float = 1e4

    # layer pattern, cycled over the depth.  Entries:
    #   "global"  full causal attention + FFN
    #   "local"   sliding-window attention + FFN
    #   "rwkv"    RWKV6 time-mix + channel-mix
    #   "rglru"   RG-LRU recurrent block + FFN
    #   "cross+global"  causal self-attn, then cross-attn to encoder, + FFN
    layer_pattern: tuple = ("global",)

    # MoE
    moe: bool = False
    num_experts: int = 0
    top_k: int = 1
    moe_d_ff: int = 0
    moe_interleave: int = 1          # every k-th layer is MoE (llama4: 2)
    capacity_factor: float = 1.25

    # families
    mixer_heads: int = 0             # rwkv6 head count (d_model/64 default)
    conv_width: int = 4              # rglru temporal conv
    d_rnn: int = 0                   # rglru recurrent width (0 -> d_model)
    encoder_layers: int = 0          # whisper encoder depth
    encoder_seq: int = 0             # stub frontend length (whisper 1500)
    cross_seq: int = 0               # vlm stub patch-sequence length

    # TP head padding: pad the q/o head axis to this count with zero
    # weights (0 = no padding).  Exact: see models/attention.py note.
    head_pad_to: int = 0

    # embeddings / numerics
    tie_embeddings: bool = True
    act: str = "swiglu"              # swiglu | gelu
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    # which shapes this arch supports (DESIGN.md shape-skip notes)
    skip_shapes: tuple = ()

    # The port-only options, as class attributes and not fields: their "off"
    # defaults, which leave the reference's architectures as they are, field
    # for field.  :class:`PortModelConfig` declares them as fields.
    dense_layers = 0                 # leading layers with a dense FFN (d_ff) before the MoE ones
    router_score = "softmax"         # softmax | sigmoid
    router_bias = False              # a per-expert bias, added to the scores for selection only
    route_scale = 1.0                # sigmoid routing: the renormalised top-k weights scaled
    shared_experts = 0               # SwiGLU experts of moe_d_ff each, run on every token
    dropless = False                 # sorted grouped-GEMM dispatch: no capacity, no drops
    attn_out_gate = False            # attention output * sigmoid(h Wgate), per channel
    rope_local_only = False          # RoPE on "local" layers only; global layers NoPE
    sandwich_norm = False            # RMSNorm on each block's output too (ln1_post, ln2_post)
    embed_scale = False              # embeddings * sqrt(d_model) on untied models too

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a lane multiple so logits stay TP-shardable
        (whisper's 51865 is the only non-divisible case)."""
        return -(-self.vocab_size // 128) * 128

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_heads(self) -> int:
        return max(self.num_heads, self.head_pad_to)

    @property
    def d_rnn_(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def mixer_heads_(self) -> int:
        return self.mixer_heads or max(self.d_model // 64, 1)

    def layer_kinds(self) -> list:
        p = self.layer_pattern
        return [p[i % len(p)] for i in range(self.num_layers)]

    def is_moe_layer(self, i: int) -> bool:
        return self.moe and i >= self.dense_layers and ((i + 1) % self.moe_interleave == 0)

    @property
    def pattern_period(self) -> int:
        """Length of the repeating super-block (layer pattern x MoE phase);
        the whole depth where leading dense layers break the repetition."""
        if self.dense_layers:
            return self.num_layers
        p = len(self.layer_pattern)
        if self.moe:
            p = int(np.lcm(p, self.moe_interleave))
        return p

    def param_count(self) -> int:
        """Total parameters (host-side arithmetic; no arrays)."""
        return sum(math.prod(leaf.shape) for leaf in leaves(param_tree(self)))

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of num_experts)."""
        if not self.moe:
            return self.param_count()
        total = 0
        for leaf in leaves(param_tree(self)):
            n = math.prod(leaf.shape)
            if "experts" in leaf.axes:
                n = n * self.top_k // max(self.num_experts, 1)
            total += n
        return total


@dataclasses.dataclass(frozen=True)
class PortModelConfig(ModelConfig):
    """A :class:`ModelConfig` with the port-only options as fields (so
    ``dataclasses.replace`` sets them): the config of an architecture the
    reference does not have."""

    dense_layers: int = 0
    router_score: str = "softmax"
    router_bias: bool = False
    route_scale: float = 1.0
    shared_experts: int = 0
    dropless: bool = False
    attn_out_gate: bool = False
    rope_local_only: bool = False
    sandwich_norm: bool = False
    embed_scale: bool = False


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple              # logical axis name (or None) per dim
    init: str = "normal"     # normal | zeros | ones
    scale: float = 0.0       # 0 -> 1/sqrt(shape[0])


def _p(shape, axes, init="normal", scale=0.0):
    assert len(shape) == len(axes), (shape, axes)
    return ParamSpec(tuple(int(s) for s in shape), tuple(axes), init, scale)


def _attention_specs(cfg: ModelConfig, cross: bool = False) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim_
    s: dict[str, Any] = {
        "wq": _p((d, h, hd), ("d_model", "heads", None)),
        "wk": _p((d, kv, hd), ("d_model", "kv_heads", None)),
        "wv": _p((d, kv, hd), ("d_model", "kv_heads", None)),
        "wo": _p((h, hd, d), ("heads", None, "d_model")),
    }
    if cfg.qkv_bias and not cross:
        s["bq"] = _p((h, hd), ("heads", None), init="zeros")
        s["bk"] = _p((kv, hd), ("kv_heads", None), init="zeros")
        s["bv"] = _p((kv, hd), ("kv_heads", None), init="zeros")
    if cfg.qk_norm:
        s["q_norm"] = _p((hd,), (None,), init="ones")
        s["k_norm"] = _p((hd,), (None,), init="ones")
    if cfg.attn_out_gate and not cross:
        s["wgate"] = _p((d, h, hd), ("d_model", "heads", None))
    return s


def _mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    s = {
        "w_in": _p((d, f), ("d_model", "d_ff")),
        "w_out": _p((f, d), ("d_ff", "d_model")),
    }
    if cfg.act == "swiglu":
        s["w_gate"] = _p((d, f), ("d_model", "d_ff"))
    return s


def _moe_specs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.num_experts
    s = {
        "router": _p((d, e), ("d_model", None)),
        "w_in": _p((e, d, f), ("experts", "d_model", None)),
        "w_out": _p((e, f, d), ("experts", None, "d_model")),
    }
    if cfg.act == "swiglu":
        s["w_gate"] = _p((e, d, f), ("experts", "d_model", None))
    if cfg.router_bias:
        s["bias"] = _p((e,), (None,), init="zeros")
    if cfg.shared_experts:
        s["shared"] = _mlp_specs(cfg, f * cfg.shared_experts)
    return s


def _rwkv_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    nh = cfg.mixer_heads_
    hs = d // nh
    lora = max(32, d // 16)
    return {
        # token-shift mix coefficients (static per-channel; x_t vs x_{t-1})
        "mu": {k: _p((d,), ("d_model",), init="zeros") for k in "rkvwg"},
        "wr": _p((d, d), ("d_model", "heads_flat")),
        "wk": _p((d, d), ("d_model", "heads_flat")),
        "wv": _p((d, d), ("d_model", "heads_flat")),
        "wg": _p((d, d), ("d_model", "heads_flat")),
        "wo": _p((d, d), ("heads_flat", "d_model")),
        # data-dependent decay LoRA: w = exp(-exp(w0 + tanh(x A) B))
        "w0": _p((d,), ("d_model",), init="zeros"),
        "wa": _p((d, lora), ("d_model", None)),
        "wb": _p((lora, d), (None, "d_model")),
        # per-head bonus u
        "u": _p((nh, hs), (None, None), init="zeros"),
        "ln_x": _p((d,), ("d_model",), init="ones"),  # group-norm gain
    }


def _rglru_specs(cfg: ModelConfig) -> dict:
    d, dr = cfg.d_model, cfg.d_rnn_
    return {
        "w_x": _p((d, dr), ("d_model", "d_ff")),     # input branch
        "w_gate_branch": _p((d, dr), ("d_model", "d_ff")),
        "conv_w": _p((cfg.conv_width, dr), (None, "d_ff"), init="zeros"),
        "conv_b": _p((dr,), ("d_ff",), init="zeros"),
        "w_input_gate": _p((dr, dr), ("d_ff", None)),
        "w_rec_gate": _p((dr, dr), ("d_ff", None)),
        "lambda_p": _p((dr,), ("d_ff",), init="ones"),  # recurrence decay param
        "w_out": _p((dr, d), ("d_ff", "d_model")),
    }


def _layer_specs(cfg: ModelConfig, layer_idx: int) -> dict:
    kind = cfg.layer_kinds()[layer_idx]
    s: dict[str, Any] = {"ln1": _p((cfg.d_model,), ("d_model",), init="ones")}
    if kind in ("global", "local"):
        s["attn"] = _attention_specs(cfg)
    elif kind == "cross+global":
        s["attn"] = _attention_specs(cfg)
        s["cross"] = _attention_specs(cfg, cross=True)
        s["ln_cross"] = _p((cfg.d_model,), ("d_model",), init="ones")
    elif kind == "rwkv":
        s["rwkv"] = _rwkv_specs(cfg)
    elif kind == "rglru":
        s["rglru"] = _rglru_specs(cfg)
    else:
        raise ValueError(kind)
    s["ln2"] = _p((cfg.d_model,), ("d_model",), init="ones")
    if cfg.sandwich_norm:
        s["ln1_post"] = _p((cfg.d_model,), ("d_model",), init="ones")
        s["ln2_post"] = _p((cfg.d_model,), ("d_model",), init="ones")
    if cfg.is_moe_layer(layer_idx):
        s["moe"] = _moe_specs(cfg)
    elif kind == "rwkv":
        # rwkv channel-mix (its own FFN form): relu(x Wk)^2 Wv with r-gate
        d, f = cfg.d_model, cfg.d_ff
        s["ffn"] = {
            "mu_k": _p((d,), ("d_model",), init="zeros"),
            "mu_r": _p((d,), ("d_model",), init="zeros"),
            "w_k": _p((d, f), ("d_model", "d_ff")),
            "w_v": _p((f, d), ("d_ff", "d_model")),
            "w_r": _p((d, d), ("d_model", None)),
        }
    else:
        s["ffn"] = _mlp_specs(cfg)
    return s


def param_tree(cfg: ModelConfig) -> dict:
    """Full parameter spec tree (pre-stacking; layers listed per depth)."""
    d = cfg.d_model
    tree: dict[str, Any] = {
        "embed": _p((cfg.padded_vocab, d), ("vocab", "d_model"), scale=1.0),
        "final_norm": _p((d,), ("d_model",), init="ones"),
        "layers": [_layer_specs(cfg, i) for i in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = _p((d, cfg.padded_vocab), ("d_model", "vocab"))
    if cfg.encoder_layers:  # whisper: encoder stack + frontend stub proj
        enc_cfg = dataclasses.replace(
            cfg, qk_norm=False, qkv_bias=False, moe=False, layer_pattern=("global",)
        )
        tree["encoder"] = {
            "layers": [
                {
                    "ln1": _p((d,), ("d_model",), init="ones"),
                    "attn": _attention_specs(enc_cfg),
                    "ln2": _p((d,), ("d_model",), init="ones"),
                    "ffn": _mlp_specs(enc_cfg),
                }
                for _ in range(cfg.encoder_layers)
            ],
            "final_norm": _p((d,), ("d_model",), init="ones"),
            "pos_embed": _p((cfg.encoder_seq, d), (None, "d_model"), scale=0.02),
        }
    return tree


# ---------------------------------------------------------------------------
# Spec-tree utilities (nested dicts and lists; dict keys in sorted order)
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the nesting (dicts, lists, tuples, ``NamedTuple``s)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def leaves(tree) -> list:
    """The leaves of ``tree``, dict keys in sorted order (``None`` skipped)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [] if tree is None else [tree]


def _unflatten(t, it):
    if isinstance(t, dict):
        return {k: _unflatten(t[k], it) for k in sorted(t)}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_unflatten(x, it) for x in t))
    if isinstance(t, (list, tuple)):
        return type(t)(_unflatten(x, it) for x in t)
    return None if t is None else next(it)


def unflatten(like, flat):
    """A tree shaped as ``like`` with ``flat``'s items as its leaves, in
    :func:`leaves` order (the inverse of ``leaves``; ``None`` stays ``None``,
    a ``NamedTuple`` keeps its type).  Module-level recursion: a nested
    recursive closure would hold ``flat`` in a reference cycle, and with it
    tensors of an autograd graph until the garbage collector runs."""
    it = iter(flat)
    out = _unflatten(like, it)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def materialize(tree, generator: torch.Generator, dtype=torch.float32, device=None) -> Any:
    """Random-init real tensors on ``device`` (default: the generator's),
    leaves drawn in :func:`leaves` order from ``generator``.  Normal leaves
    are N(0, 1) * (spec.scale or 1/sqrt(shape[0])), drawn in f32 and cast,
    as the reference scales them (a stacked leaf's shape[0] is its layer
    count)."""
    device = generator.device if device is None else torch.device(device)

    def mk(spec: ParamSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        scale = spec.scale or 1.0 / np.sqrt(max(spec.shape[0], 1))
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x.mul_(scale)).to(device=device, dtype=dtype)

    return tree_map(lambda s: None if s is None else mk(s), tree)


def abstract(tree, dtype) -> Any:
    """Meta-tensor stand-ins (``device="meta"``: shape and dtype, no
    storage), the dry run's counterpart of the reference's
    ``ShapeDtypeStruct`` tree."""
    return tree_map(lambda s: None if s is None else torch.empty(s.shape, dtype=dtype,
                                                                device="meta"), tree)


def logical_axes(tree) -> Any:
    """Tree of logical-axes tuples, same structure as the param tree."""
    return tree_map(lambda s: None if s is None else s.axes, tree)


def _stack(*xs):
    """One stacked leaf of :func:`stack_layers`: a spec with a leading
    ``layers`` axis, or arrays/tensors stacked along a new axis 0."""
    if isinstance(xs[0], ParamSpec):
        return ParamSpec((len(xs),) + xs[0].shape, ("layers",) + xs[0].axes, xs[0].init,
                         xs[0].scale)
    return torch.stack(xs) if isinstance(xs[0], torch.Tensor) else np.stack(xs)


def stack_layers(cfg: ModelConfig, tree: dict) -> dict:
    """Group per-depth layers into super-blocks of ``pattern_period``
    layers with a leading ``layers`` axis, as the reference lays out its
    params for ``lax.scan``; a remainder of ``num_layers % period`` layers
    stays unstacked in ``tail``.  Leaves are specs, numpy arrays or
    tensors.  The port runs the layers in a Python loop but keeps this
    layout, so reference params bridge as they are."""
    period = cfg.pattern_period
    n_super, _ = divmod(cfg.num_layers, period)
    layers = tree["layers"]
    out = {k: v for k, v in tree.items() if k != "layers"}
    if n_super <= 1:
        out["blocks"] = None
        out["tail"] = list(layers)
        return out
    body = layers[: n_super * period]
    out["tail"] = list(layers[n_super * period:])
    out["blocks"] = [
        tree_map(_stack, *[body[j * period + t] for j in range(n_super)])
        for t in range(period)
    ]
    return out


def model_spec_tree(cfg: ModelConfig) -> dict:
    """The deployable spec tree: param_tree with layers stacked."""
    return stack_layers(cfg, param_tree(cfg))
