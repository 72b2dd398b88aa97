"""GraphSAGE for AIG node classification (paper §III-C/D), in PyTorch.

Port of ``repro/core/gnn.py`` (inference and training).  Direction- and
polarity-separated SAGE: each layer aggregates its fanin edges in four
(slot x polarity) groups and its fanout edges in two, with separate weights:

    h'_u = relu( W_s h_u + sum_g W_g mean_{g-edges of u} h_v + b )

The parameters live in :class:`GrootGNN` (weights stored ``(in, out)`` and
applied as ``h @ W``, as in the reference).  They are bridged from and to
the reference's numpy tree ``{"layers": [{w_self, w_in_*, w_out_*, b}],
"head": {w, b}}`` by :func:`params_from_numpy` / :func:`params_to_numpy`,
and stored as a flat ``.npz`` (:func:`load_params` / :func:`save_params`).

Training (:func:`init_params`, :func:`loss_fn`, :func:`train_step`,
:func:`train`) runs the segment-sum path (``agg=None``), as the reference's
does, with the hand-written AdamW of ``repro_torch.training.optimizer``.  The
CUDA kernels have no backward: :func:`forward` on any other backend raises
when a gradient is asked for, and the predict paths run without a graph.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.core import aig as A
from repro_torch.core import prng
from repro_torch.kernels import ref as kref
from repro_torch.obs import REGISTRY, span
from repro_torch.training import optimizer as opt


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    in_features: int = 4
    hidden: int = 32
    num_layers: int = 4
    num_classes: int = A.NUM_CLASSES
    # dtype of the staged edge streams (staged weights + gathered features)
    # on the groot* backends: "float32" or "bfloat16" (kernels accumulate
    # in f32).  Read by the pipeline; direct forward/predict callers pass
    # ``stream_dtype=``.
    stream_dtype: str = "float32"


IN_GROUPS = ("w_in_l_pos", "w_in_l_neg", "w_in_r_pos", "w_in_r_neg")
OUT_GROUPS = ("w_out_pos", "w_out_neg")
LAYER_WEIGHTS = ("w_self",) + IN_GROUPS + OUT_GROUPS


class SageLayer(nn.Module):
    """One layer's weights: ``w_self`` and one ``(in, out)`` matrix per group."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        for nm in LAYER_WEIGHTS:
            self.register_parameter(nm, nn.Parameter(torch.zeros(d_in, d_out)))
        self.b = nn.Parameter(torch.zeros(d_out))

    def stack(self, names) -> torch.Tensor:
        """The (G, in, out) weight stack of the named groups, contiguous f32."""
        return torch.stack([getattr(self, nm) for nm in names]).float().contiguous()


class Head(nn.Module):
    def __init__(self, hidden: int, num_classes: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(hidden, num_classes))
        self.b = nn.Parameter(torch.zeros(num_classes))


class GrootGNN(nn.Module):
    """The model's parameters; :meth:`forward` is :func:`forward`."""

    def __init__(self, cfg: GNNConfig):
        super().__init__()
        self.cfg = cfg
        dims = [cfg.in_features] + [cfg.hidden] * cfg.num_layers
        self.layers = nn.ModuleList(
            SageLayer(dims[i], dims[i + 1]) for i in range(cfg.num_layers)
        )
        self.head = Head(cfg.hidden, cfg.num_classes)

    def forward(self, x, edge_src, edge_dst, edge_inv=None, edge_slot=None, *,
                num_nodes: int, agg=None, stream_dtype: Optional[str] = None):
        return forward(self, x, edge_src, edge_dst, edge_inv, edge_slot,
                       num_nodes=num_nodes, agg=agg, stream_dtype=stream_dtype)


# ---------------------------------------------------------------------------
# Params bridge
# ---------------------------------------------------------------------------

def init_params(cfg: GNNConfig, seed: int = 0, device="cpu") -> GrootGNN:
    """Fresh trainable params, drawn as the reference's
    ``init_params(cfg, jax.random.key(seed))`` draws them
    (:mod:`repro_torch.core.prng`): per layer ``split(key, 8)``, the first
    key carrying on and the other seven drawing ``w_self``, the four
    ``IN_GROUPS`` and the two ``OUT_GROUPS`` uniform(+-1/sqrt(fan_in)); then
    ``split(key, 2)`` for the head; zero biases.  The values are built on
    the host and moved to ``device``, so every device starts alike."""
    dims = [cfg.in_features] + [cfg.hidden] * cfg.num_layers
    key = prng.key(seed)
    tree = {"layers": []}
    for i in range(cfg.num_layers):
        key, *keys = prng.split(key, 1 + len(LAYER_WEIGHTS))
        s = 1.0 / np.sqrt(dims[i])
        layer = {nm: prng.uniform(kk, (dims[i], dims[i + 1]), -s, s)
                 for nm, kk in zip(LAYER_WEIGHTS, keys)}
        layer["b"] = np.zeros(dims[i + 1], np.float32)
        tree["layers"].append(layer)
    key, kh = prng.split(key, 2)
    s = 1.0 / np.sqrt(cfg.hidden)
    tree["head"] = {"w": prng.uniform(kh, (cfg.hidden, cfg.num_classes), -s, s),
                    "b": np.zeros(cfg.num_classes, np.float32)}
    return params_from_numpy(tree, device=device).requires_grad_(True)


def params_from_numpy(tree: dict, device="cpu") -> GrootGNN:
    """Build a :class:`GrootGNN` from the reference's params tree (numpy or
    anything ``np.asarray`` takes); values are copied exactly.  The params
    are for inference (``requires_grad`` off): :func:`train` makes its own
    trainable copy."""
    layers = tree["layers"]
    cfg = GNNConfig(
        in_features=int(np.shape(layers[0]["w_self"])[0]),
        hidden=int(np.shape(layers[0]["w_self"])[1]),
        num_layers=len(layers),
        num_classes=int(np.shape(tree["head"]["w"])[1]),
    )
    model = GrootGNN(cfg)
    with torch.no_grad():
        for mod, layer in zip(model.layers, layers):
            for nm in LAYER_WEIGHTS + ("b",):
                getattr(mod, nm).copy_(torch.as_tensor(np.array(layer[nm], np.float32)))
        model.head.w.copy_(torch.as_tensor(np.array(tree["head"]["w"], np.float32)))
        model.head.b.copy_(torch.as_tensor(np.array(tree["head"]["b"], np.float32)))
    return model.requires_grad_(False).to(device)


def as_model(params, device) -> GrootGNN:
    """Params as a model on ``device``: a :class:`GrootGNN` (copied, never
    moved in place), the reference's numpy tree, or a ``.npz`` path."""
    if isinstance(params, GrootGNN):
        params = params_to_numpy(params)
    elif not isinstance(params, dict):
        params = load_params(params)
    return params_from_numpy(params, device=device)


def params_to_numpy(model: GrootGNN) -> dict:
    """The reference's params tree, as numpy float32 arrays."""
    def a(p):
        return p.detach().cpu().numpy().copy()

    return {
        "layers": [
            {nm: a(getattr(mod, nm)) for nm in LAYER_WEIGHTS + ("b",)}
            for mod in model.layers
        ],
        "head": {"w": a(model.head.w), "b": a(model.head.b)},
    }


def save_params(tree: dict, path) -> None:
    """Write a params tree as a flat ``.npz`` (keys ``layers.<i>.<name>``,
    ``head.w``, ``head.b``)."""
    flat = {
        f"layers.{i}.{nm}": np.asarray(v, np.float32)
        for i, layer in enumerate(tree["layers"]) for nm, v in layer.items()
    }
    flat.update({f"head.{nm}": np.asarray(v, np.float32) for nm, v in tree["head"].items()})
    np.savez(path, **flat)


def load_params(path) -> dict:
    """Read a params tree written by :func:`save_params`."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    n = 1 + max(int(k.split(".")[1]) for k in flat if k.startswith("layers."))
    return {
        "layers": [
            {nm: flat[f"layers.{i}.{nm}"] for nm in LAYER_WEIGHTS + ("b",)}
            for i in range(n)
        ],
        "head": {"w": flat["head.w"], "b": flat["head.b"]},
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _segment_sum(w: torch.Tensor, idx: torch.Tensor, num_nodes: int) -> torch.Tensor:
    out = torch.zeros((num_nodes,) + tuple(w.shape[1:]), dtype=w.dtype, device=w.device)
    return out.index_add_(0, idx, w)


def _stream_dtype(stream_dtype: Optional[str]) -> Optional[torch.dtype]:
    if stream_dtype is None or stream_dtype == "float32":
        return None
    return getattr(torch, stream_dtype)


def _head(params: GrootGNN, h: torch.Tensor) -> torch.Tensor:
    return h @ params.head.w + params.head.b


def _wants_grad(params: GrootGNN, x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in params.parameters()))


#: forward signatures seen by this process: the port runs eagerly, so
#: ``gnn.forward_traces`` counts what the reference's jit would trace, the
#: first forward of each (shape, backend, dtype, grad) signature
_TRACED: set = set()
_TRACED_MAX = 4096


def _count_trace(x, edge_src, num_nodes, agg, stream_dtype) -> None:
    sig = (tuple(x.shape), int(edge_src.shape[0]), int(num_nodes),
           None if agg is None else agg.backend, stream_dtype, torch.is_grad_enabled())
    if sig not in _TRACED:
        if len(_TRACED) >= _TRACED_MAX:
            _TRACED.clear()
        _TRACED.add(sig)
        REGISTRY.counter("gnn.forward_traces").inc()


def forward(
    params: GrootGNN,
    x: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_inv: Optional[torch.Tensor] = None,
    edge_slot: Optional[torch.Tensor] = None,
    *,
    num_nodes: int,
    agg=None,
    stream_dtype: Optional[str] = None,
) -> torch.Tensor:
    """Full forward pass -> logits (num_nodes, num_classes).

    ``agg`` is an :class:`repro_torch.kernels.ops.AggPair` (or None for the
    gather + ``index_add_`` reference).  Paths, most specific wins:

      * **hoisted grouped** (``fwd_plan`` present — the groot backends):
        group-weight streams staged once per forward, activations padded
        once per layer and shared by both directions, scatter-free
        assembly; ``stream_dtype="bfloat16"`` narrows the staged streams.
      * **grouped** (``in_agg_grouped`` present): one grouped aggregation
        per direction per layer, mean norms folded into the (E, 4) / (E, 2)
        weights, the per-group ``@ W`` as one ``einsum`` (or fused).
      * **fused per-group** (``in_agg_mm`` present — ``ops.ungrouped`` of
        a ``groot_fused`` pair): per-group ``agg @ W`` inside the kernel
        (K7), the fanin norm folded into the edge weights (post-scaling
        would be wrong: the aggregated row is never materialised).
      * **per-group loop** (ref / onehot / None): aggregate per group, then
        post-scale by the per-destination norm.

    Only the plain reference (``agg=None``) records a graph for autograd.
    The CUDA kernels have no backward: on any other backend, a call with
    grad mode on and params (or ``x``) that require grad raises instead of
    returning logits whose gradient would silently be zero; otherwise it
    runs under ``torch.no_grad()``.

    The body runs under the ``gnn.forward`` span: the host's side of the
    launches, which the device may run well after the span has closed.
    """
    with span("gnn.forward"):
        _count_trace(x, edge_src, num_nodes, agg, stream_dtype)
        if agg is None:
            return _forward(params, x, edge_src, edge_dst, edge_inv, edge_slot,
                            num_nodes=num_nodes, agg=None, stream_dtype=stream_dtype)
        if _wants_grad(params, x):
            raise RuntimeError(
                "the aggregation kernels have no backward: train on the plain "
                "reference (agg=None), or run this backend under torch.no_grad()")
        with torch.no_grad():
            return _forward(params, x, edge_src, edge_dst, edge_inv, edge_slot,
                            num_nodes=num_nodes, agg=agg, stream_dtype=stream_dtype)


def _forward(params, x, edge_src, edge_dst, edge_inv, edge_slot, *, num_nodes, agg,
             stream_dtype):
    if getattr(agg, "in_agg_grouped", None) is not None and \
            getattr(agg, "out_agg_grouped", None) is not None:
        wg_in, wg_out = grouped_edge_weights(edge_src, edge_dst, edge_inv, edge_slot,
                                             num_nodes, x.dtype)
        return _forward_grouped(params, x, wg_in, wg_out, agg, stream_dtype=stream_dtype)

    group_w, out_w = _group_weights(edge_dst, edge_inv, edge_slot, x.dtype)
    norm_in = {
        nm: (1.0 / torch.clamp_min(_segment_sum(w, edge_dst, num_nodes), 1.0))[:, None]
        for nm, w in group_w.items()
    }
    norm_out = {
        nm: (1.0 / torch.clamp_min(_segment_sum(w, edge_src, num_nodes), 1.0))[:, None]
        for nm, w in out_w.items()
    }
    if agg is None:
        def in_agg(h, w):
            return kref.spmm_ref(h, edge_src, edge_dst, num_nodes, w)

        def out_agg(h, w):
            return kref.spmm_ref(h, edge_dst, edge_src, num_nodes, w)
        in_agg_mm = None
    else:
        in_agg, out_agg, in_agg_mm = agg.in_agg, agg.out_agg, agg.in_agg_mm

    if in_agg_mm is not None:  # fused path: fold the norms into the edge weights
        group_w = {nm: w * norm_in[nm][:, 0][edge_dst] for nm, w in group_w.items()}

    h = x
    for layer in params.layers:
        acc = h @ layer.w_self + layer.b
        for nm in IN_GROUPS:
            if in_agg_mm is not None:
                acc = acc + in_agg_mm(h, group_w[nm], getattr(layer, nm))
            else:
                acc = acc + (in_agg(h, group_w[nm]) * norm_in[nm]) @ getattr(layer, nm)
        for nm in OUT_GROUPS:
            acc = acc + (out_agg(h, out_w[nm]) * norm_out[nm]) @ getattr(layer, nm)
        h = torch.relu(acc)
    return _head(params, h)


def _group_weights(edge_dst, edge_inv, edge_slot, dtype) -> tuple[dict, dict]:
    """Per-edge 0/1 membership of each fanin and fanout group."""
    one = torch.ones(edge_dst.shape[0], dtype=dtype, device=edge_dst.device)
    w_neg = edge_inv.to(dtype) if edge_inv is not None else torch.zeros_like(one)
    w_pos = 1.0 - w_neg
    w_r = edge_slot.to(dtype) if edge_slot is not None else torch.zeros_like(one)
    w_l = 1.0 - w_r
    group_w = {
        "w_in_l_pos": w_l * w_pos,
        "w_in_l_neg": w_l * w_neg,
        "w_in_r_pos": w_r * w_pos,
        "w_in_r_neg": w_r * w_neg,
    }
    out_w = {"w_out_pos": w_pos, "w_out_neg": w_neg}
    return group_w, out_w


def grouped_edge_weights(edge_src, edge_dst, edge_inv, edge_slot, num_nodes: int,
                         dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """The (E, 4) fanin and (E, 2) fanout group-weight matrices (column
    order IN_GROUPS / OUT_GROUPS) with each group's per-destination mean
    norm folded in — the weights the grouped SpMM walks consume."""
    group_w, out_w = _group_weights(edge_dst, edge_inv, edge_slot, dtype)
    wg_in = torch.stack([group_w[nm] for nm in IN_GROUPS], dim=1)      # (E, 4)
    wg_out = torch.stack([out_w[nm] for nm in OUT_GROUPS], dim=1)      # (E, 2)
    deg_in = _segment_sum(wg_in, edge_dst, num_nodes)
    deg_out = _segment_sum(wg_out, edge_src, num_nodes)
    wg_in = wg_in * (1.0 / torch.clamp_min(deg_in, 1.0))[edge_dst]
    wg_out = wg_out * (1.0 / torch.clamp_min(deg_out, 1.0))[edge_src]
    return wg_in, wg_out


def _forward_grouped(params, x, wg_in, wg_out, agg, *, stream_dtype: Optional[str] = None):
    """Grouped hot path: one aggregation per direction per layer over the
    normalised (E, G) group weights."""
    fp = getattr(agg, "fwd_plan", None)
    if fp is not None and agg.in_agg_staged is not None:
        return _forward_hoisted(params, x, wg_in, wg_out, agg, fp, stream_dtype)

    h = x
    for layer in params.layers:
        acc = h @ layer.w_self + layer.b
        w_in_stack = layer.stack(IN_GROUPS)
        w_out_stack = layer.stack(OUT_GROUPS)
        if agg.in_agg_mm_grouped is not None:
            acc = acc + agg.in_agg_mm_grouped(h, wg_in, w_in_stack)
        else:
            gin = agg.in_agg_grouped(h, wg_in)                        # (4, N, F)
            acc = acc + torch.einsum("gnf,gfh->nh", gin.to(acc.dtype), w_in_stack)
        gout = agg.out_agg_grouped(h, wg_out)                         # (2, N, F)
        acc = acc + torch.einsum("gnf,gfh->nh", gout.to(acc.dtype), w_out_stack)
        h = torch.relu(acc)
    return _head(params, h)


def _forward_hoisted(params, x, wg_in, wg_out, agg, fp, stream_dtype):
    """Hoisted grouped hot path: the fanin/fanout group-weight streams are
    staged into kernel layout ONCE per forward; activations are padded once
    per layer, shared by both direction walks; output assembly inside the
    walks is one permutation gather.  ``stream_dtype="bfloat16"`` narrows
    the staged weight streams and the gathered features; the kernels
    accumulate in f32."""
    sdt = _stream_dtype(stream_dtype)
    sw_in = fp.stage_in(wg_in, dtype=sdt)
    sw_out = fp.stage_out(wg_out, dtype=sdt)
    fused = agg.in_agg_mm_staged is not None
    h = x
    for layer in params.layers:
        w_in_stack = layer.stack(IN_GROUPS)
        w_out_stack = layer.stack(OUT_GROUPS)
        acc = h @ layer.w_self + layer.b
        h_p = fp.pad_x(h)
        if sdt is not None:
            h_p = h_p.to(sdt)
        if fused:
            acc = acc + agg.in_agg_mm_staged(h_p, sw_in, w_in_stack).to(acc.dtype)
        else:
            gin = agg.in_agg_staged(h_p, sw_in)                       # (4, N, F)
            acc = acc + torch.einsum("gnf,gfh->nh", gin.to(acc.dtype), w_in_stack)
            del gin
        gout = agg.out_agg_staged(h_p, sw_out)                        # (2, N, F)
        acc = acc + torch.einsum("gnf,gfh->nh", gout.to(acc.dtype), w_out_stack)
        del gout, h_p
        h = torch.relu(acc)
    return _head(params, h)


# ---------------------------------------------------------------------------
# Training (the segment-sum path, as the reference trains)
# ---------------------------------------------------------------------------

def loss_fn(params: GrootGNN, batch: dict) -> torch.Tensor:
    """Mean cross-entropy of the logits against ``batch["labels"]``, over
    the rows ``batch["mask"]`` selects where it is given."""
    logits = forward(
        params, batch["x"], batch["edge_src"], batch["edge_dst"],
        batch.get("edge_inv"), batch.get("edge_slot"), num_nodes=batch["x"].shape[0],
    )
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(1, batch["labels"].long()[:, None])[:, 0]
    mask = batch.get("mask")
    if mask is not None:
        return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return -ll.mean()


def train_step(params: GrootGNN, state: opt.AdamWState, batch: dict,
               optimizer: opt.AdamW) -> tuple[GrootGNN, opt.AdamWState, torch.Tensor]:
    """One AdamW step on ``params`` (updated in place); returns (params,
    state, the loss before the step)."""
    ps = list(params.parameters())
    loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, ps)
    updates, state = optimizer.update(grads, state, ps)
    with torch.no_grad():
        for p, new in zip(ps, opt.apply_updates(ps, updates)):
            p.copy_(new)
    return params, state, loss.detach()


def make_batch(design, features: np.ndarray, labels: np.ndarray, device=None) -> dict:
    """The training batch of a design on ``device`` (``cuda`` unless named)."""
    device = resolve_device(device)
    g = design.to_edge_graph() if hasattr(design, "to_edge_graph") else design
    src, dst, inv, slot = graph_tensors(g, device)
    batch = {
        "x": torch.as_tensor(np.asarray(features, np.float32)).to(device),
        "edge_src": src,
        "edge_dst": dst,
        "labels": torch.as_tensor(labels.astype(np.int32)).to(device),
    }
    if inv is not None:
        batch["edge_inv"] = inv
    if slot is not None:
        batch["edge_slot"] = slot
    return batch


def train(
    params: GrootGNN,
    batch: dict,
    *,
    epochs: int = 200,
    lr: float = 5e-3,
    log_every: int = 0,
) -> tuple[GrootGNN, list]:
    """``epochs`` AdamW steps (``lr``, weight decay 1e-4) on a trainable
    copy of ``params`` (the input is left as it is); returns the trained
    copy and ``[(epoch, loss), ...]`` every ``log_every`` epochs and at the
    last.  On a CUDA device ``index_add_`` adds with atomics, so the losses
    are repeatable only to rounding."""
    import copy

    params = copy.deepcopy(params).requires_grad_(True)
    optimizer = opt.AdamW(lr=lr, weight_decay=1e-4)
    state = optimizer.init(list(params.parameters()))
    history = []
    for e in range(epochs):
        params, state, loss = train_step(params, state, batch, optimizer)
        if log_every and (e % log_every == 0 or e == epochs - 1):
            history.append((e, float(loss)))
    return params, history


# ---------------------------------------------------------------------------
# Prediction
# ---------------------------------------------------------------------------

def _make_agg(structure, backend: str, device, *, cache: bool = True):
    """The aggregation pair for a prepared structure (an EdgeGraph or a
    Subgraph; None = the plain reference), looked up by its memoized
    structure keys (``plan_cache.keys_of``)."""
    if backend in (None, "ref"):
        return None
    from repro_torch.kernels import ops, plan_cache

    return ops.make_agg_pair(structure.edge_src, structure.edge_dst, structure.num_nodes,
                             backend, device=device, cache=cache,
                             gkeys=plan_cache.keys_of(structure))


def staged_bytes(tensors) -> int:
    """The bytes of ``tensors`` (None entries skipped): a ``gnn.stage``
    span's ``bytes``."""
    return sum(t.nbytes for t in tensors if t is not None)


def graph_tensors(g, device) -> tuple:
    """(edge_src, edge_dst, edge_inv, edge_slot) of an EdgeGraph on ``device``
    (indices int64; missing annotations stay None), copied under the
    ``gnn.stage`` span."""
    def t(a, dtype=None):
        a = torch.as_tensor(np.ascontiguousarray(a))
        return a.to(device=device, dtype=dtype)

    with span("gnn.stage") as sp, warnings.catch_warnings():
        # a keyed graph's endpoints are read-only (plan_cache.keys_of): the
        # copies only read them
        warnings.filterwarnings("ignore", "The given NumPy array is not writable",
                                UserWarning)
        out = (
            t(g.edge_src, torch.int64),
            t(g.edge_dst, torch.int64),
            None if g.edge_inv is None else t(g.edge_inv),
            None if g.edge_slot is None else t(g.edge_slot),
        )
        sp.set(bytes=staged_bytes(out))
    return out


def readback(logits: torch.Tensor) -> np.ndarray:
    """The int32 argmax of ``logits`` on the host, under the ``gnn.readback``
    span.  The copy to the host waits for the device to finish the forward
    the launches queued, so the span holds that wait as well as the argmax
    and the copy."""
    with span("gnn.readback"):
        return logits.argmax(dim=-1).to(torch.int32).cpu().numpy()


def _params_on(params: GrootGNN, device) -> torch.device:
    device = resolve_device(device)
    p_dev = next(params.parameters()).device
    if p_dev.type != device.type or (device.index is not None and p_dev != device):
        raise ValueError(f"params lie on {p_dev}, prediction runs on {device}")
    return device


@torch.no_grad()
def _predict_graph(params, num_nodes: int, tensors, features, agg, stream_dtype,
                   device) -> np.ndarray:
    with span("gnn.stage") as sp:
        x = torch.as_tensor(np.asarray(features, np.float32)).to(device)
        sp.set(bytes=x.nbytes)
    logits = forward(
        params, x, *tensors, num_nodes=num_nodes, agg=agg, stream_dtype=stream_dtype,
    )
    return readback(logits)


def predict(params: GrootGNN, design, features, backend: str = "ref", *,
            stream_dtype: Optional[str] = None, device=None) -> np.ndarray:
    """Per-node class predictions (int32 argmax of the logits), computed on
    ``device`` (``cuda`` unless the caller names another)."""
    device = _params_on(params, device)
    g = design.to_edge_graph() if hasattr(design, "to_edge_graph") else design
    feats = np.asarray(features)
    # staged h2d bytes: features + the edge index/annotation arrays
    REGISTRY.counter("gnn.bytes_staged").inc(
        feats.nbytes + 2 * g.edge_src.nbytes + 2 * g.edge_dst.nbytes)
    with span("gnn.predict", backend=backend, nodes=g.num_nodes):
        REGISTRY.counter("gnn.predicts").inc()
        return _predict_graph(params, g.num_nodes, graph_tensors(g, device), feats,
                              _make_agg(g, backend, device), stream_dtype, device)


def _same_structure(a, b) -> bool:
    if (a.num_nodes, a.num_edges) != (b.num_nodes, b.num_edges):
        return False
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("edge_src", "edge_dst", "edge_inv", "edge_slot"))


def structure_groups(subgraphs) -> list[list[int]]:
    """Indices of ``subgraphs`` grouped by identical structure (node count
    and every edge array), groups in order of first appearance: the copies
    of a batched design cut at the same places fall in one group."""
    groups: list[list[int]] = []
    for i, sg in enumerate(subgraphs):
        for grp in groups:
            if _same_structure(subgraphs[grp[0]], sg):
                grp.append(i)
                break
        else:
            groups.append([i])
    return groups


def predict_partitioned(
    params: GrootGNN,
    subgraphs,
    features: np.ndarray,
    num_nodes: int,
    backend: str = "ref",
    *,
    streaming: bool = True,
    capacity: int = 2,
    prefetch: int = 1,
    stream_dtype: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """DEPRECATED: per-partition inference; core-node predictions only.

    Use :class:`repro_torch.api.Session` (whose router picks the streamed or
    sequential path) or call
    :func:`repro_torch.exec.stream.stream_predict_partitioned` /
    :func:`predict_partitioned_loop` directly.  Kept as the reference's
    behaviour-preserving shim: the subgraphs stream through the
    ``repro_torch.exec`` executor by default, or run through the sequential
    per-subgraph loop with ``streaming=False`` — the same core predictions
    either way.
    """
    import warnings

    warnings.warn(
        "gnn.predict_partitioned is deprecated; use repro_torch.api.Session "
        "(or stream_predict_partitioned / predict_partitioned_loop)",
        DeprecationWarning,
        stacklevel=2,
    )
    if streaming:
        from repro_torch.exec.stream import stream_predict_partitioned

        return stream_predict_partitioned(
            params, subgraphs, features, num_nodes, backend, capacity=capacity,
            prefetch=prefetch, stream_dtype=stream_dtype, device=device,
        )
    return predict_partitioned_loop(
        params, subgraphs, features, num_nodes, backend, stream_dtype=stream_dtype,
        device=device,
    )


def predict_partitioned_loop(
    params: GrootGNN,
    subgraphs,
    features: np.ndarray,
    num_nodes: int,
    backend: str = "ref",
    *,
    stream_dtype: Optional[str] = None,
    device=None,
    on_partition=None,
) -> np.ndarray:
    """Sequential partitioned inference (port of the reference's
    ``predict_partitioned_loop``): one unpadded full-graph forward per
    re-grown subgraph on ``features[sg.global_ids]``; each subgraph's core
    rows are scattered into an int32 prediction of ``num_nodes``.

    The subgraphs run one structure at a time (:func:`structure_groups`;
    core rows are disjoint, so the order does not change the result).  A
    structure's edge tensors and aggregation pair go to the device once,
    serve every subgraph of that structure, and are dropped after the last
    one: the pair is built outside the structural cache and its plans'
    device copies are released, so at most one partition's working set is
    resident.  The host plans stay cached.  ``on_partition(i, sg)`` is
    called after partition ``i``'s predictions reached the host (and, for
    a structure's last partition, after its device copies were dropped).
    """
    from repro_torch.kernels import ops

    device = _params_on(params, device)
    out = np.zeros(num_nodes, dtype=np.int32)
    for group in structure_groups(subgraphs):
        g = subgraphs[group[0]].to_edge_graph()
        tensors = graph_tensors(g, device)
        agg = _make_agg(subgraphs[group[0]], backend, device, cache=False)
        for i in group:
            sg = subgraphs[i]
            feats = features[sg.global_ids]
            REGISTRY.counter("gnn.loop_launches").inc()
            REGISTRY.counter("gnn.bytes_staged").inc(
                int(feats.nbytes) + 2 * sg.edge_src.nbytes + 2 * sg.edge_dst.nbytes)
            pred = _predict_graph(params, g.num_nodes, tensors, feats, agg, stream_dtype,
                                  device)
            out[sg.global_ids[: sg.num_core]] = pred[: sg.num_core]
            if i == group[-1]:
                if agg is not None:
                    ops.release_device(agg)
                tensors = agg = None
            if on_partition is not None:
                on_partition(i, sg)
    return out


def accuracy(pred: np.ndarray, labels: np.ndarray) -> float:
    return float((pred == labels).mean())
