"""Per-device cost of a traced step (counterpart of
``src/repro/roofline/hlo.py``).

The reference compiles each dry-run cell and parses the per-device SPMD
HLO for loop-corrected dot FLOPs, collective bytes and a static HBM-traffic
proxy.  The port runs the step itself, eagerly, on fake tensors (no storage,
no kernel) and counts what each rank would execute:

:class:`CostCounter` is a ``TorchDispatchMode``.  It steps aside for
DTensor operands (``NotImplemented``), so DTensor's dispatch runs and the
counter sees the ops DTensor issues on each rank's *local* shards, and the
functional collectives its redistributions issue.  Everything is therefore
counted **per device**, as the reference's per-device module is: a
``FlopCounterMode`` around a DTensor matmul would count the global
2·M·K·N, and the roofline divides per-device work by one card's rate.  The
fake process group stands every rank in for rank 0, so an uneven split
counts rank 0's (the largest) share.  The step runs as a Python loop, so
no loop correction is needed: a loop of 5 matmuls is 5 matmuls.

  * ``dot_flops``: matmul-class ops by ``torch.utils.flop_counter``'s
    formulas (mm, addmm, bmm, baddbmm, convolutions, SDPA) plus any formula
    registered for a custom op (K8's, ``kernels/flash_attention.py``);
  * ``collective_bytes`` / ``collective_by_kind``: the functional
    collectives by kind (all-gather, all-reduce, reduce-scatter,
    all-to-all, collective-permute), in result bytes, as ``hlo.py`` bills
    them;
  * ``traffic_bytes``: every op's tensor inputs read and outputs written,
    skipping views, reshapes, copies and dtype-only casts (the ops
    ``hlo.py`` skips as fused into their consumers) and factories; plus the
    entry arguments read once;
  * ``entry_param_bytes``: the step's arguments' local bytes;
  * DTensor derives each op's global output shape by running the op once
    on global-shaped fake tensors (its sharding propagation); no rank runs
    that, so the counter skips whatever runs inside it;
  * ``peak_bytes``: the most bytes live at once on the device: the
    arguments plus every storage the step allocates, freed when its last
    reference dies (storage finalizers, so autograd's saved tensors and
    checkpoint recomputes are followed as they are on the card).  This
    stands in for the reference's ``memory_analysis`` argument plus temp.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "isend": "collective-permute",
    "batch_p2p_ops": "collective-permute",
}

# layout/dtype ops: fused into their consumers on the card, as hlo.py skips
# convert / broadcast / reshape / transpose / copy
_SKIP_TRAFFIC = {
    "_to_copy", "clone", "copy_", "_unsafe_view", "view", "reshape", "expand", "contiguous",
    "lift_fresh", "lift_fresh_copy", "detach", "alias", "wait_tensor", "empty_like",
    "zeros_like", "ones_like", "new_empty", "new_zeros", "empty_strided", "t", "transpose",
    "permute", "_reshape_alias", "unsqueeze", "squeeze", "slice", "select", "split",
    "unbind", "as_strided", "split_with_sizes", "diagonal",
}


_STATE = threading.local()


@contextlib.contextmanager
def _uncounted():
    prev = getattr(_STATE, "propagating", False)
    _STATE.propagating = True
    try:
        yield
    finally:
        _STATE.propagating = prev


@contextlib.contextmanager
def _skip_sharding_propagation():
    """Mark DTensor's shape propagation (an op run once on global-shaped
    fake tensors to learn its output's shape) as uncounted."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def wrapped(self, op_schema):
        with _uncounted():
            return orig(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = wrapped
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class CostStats:
    """The counts of one traced step (``hlo.HloStats``'s fields, plus the
    peak)."""

    dot_flops: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    traffic_bytes: float = 0.0
    entry_param_bytes: float = 0.0
    peak_bytes: float = 0.0
    ops: int = 0


class CostCounter(TorchDispatchMode):
    """Count a step's per-device cost (see the module docstring)::

        with FakeTensorMode(), CostCounter(args) as c:
            step(*args)
        c.stats.dot_flops

    ``args``: the step's arguments (DTensors count their local shards)."""

    def __init__(self, args=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.flop_registry = flop_registry
        self.stats = CostStats()
        local = [_local(t) for t in _tensors(args)]
        seen = {}
        for t in local:
            seen[_storage_key(t)] = t.untyped_storage().nbytes()
        self.stats.entry_param_bytes = float(sum(seen.values()))
        self._held = set(seen)        # arguments: live for the whole step
        self._live = 0
        self._tracked = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if getattr(_STATE, "propagating", False) or func is torch.ops.prim.device.default:
            return out
        ins = _tensors((args, kwargs))
        if any(t.device.type == "meta" for t in ins):
            return out  # DTensor's own shape propagation, no device work
        self._count(func, args, kwargs, ins, out)
        return out

    def _count(self, func, args, kwargs, ins, out) -> None:
        st = self.stats
        st.ops += 1
        packet = func.overloadpacket
        name = packet.__name__
        outs = _tensors(out)
        if packet in self.flop_registry:
            st.dot_flops += float(self.flop_registry[packet](*args, **kwargs, out_val=out))
        kind = COLLECTIVES.get(name) if func.namespace in ("_c10d_functional", "c10d") else None
        if kind is not None:
            b = float(sum(_nbytes(t) for t in (outs or ins)))
            st.collective_bytes += b
            st.collective_by_kind[kind] += b
        if ins and not func.is_view and name not in _SKIP_TRAFFIC:
            st.traffic_bytes += float(sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs))
        for t in outs:
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        try:
            storage = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return
        key = _storage_key(t)
        if key in self._tracked or key in self._held:
            return
        n = storage.nbytes()
        self._tracked.add(key)
        self._live += n
        self.stats.peak_bytes = max(self.stats.peak_bytes, self._live)
        weakref.finalize(storage, self._free, key, n)

    def _free(self, key, n: int) -> None:
        self._tracked.discard(key)
        self._live -= n

    def __enter__(self):
        self._patch = _skip_sharding_propagation()
        self._patch.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._patch.__exit__(*exc)
        st = self.stats
        st.peak_bytes = st.entry_param_bytes + st.peak_bytes
        st.traffic_bytes += st.entry_param_bytes
        st.collective_by_kind = dict(st.collective_by_kind)
        return out


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _storage_key(t: torch.Tensor):
    return id(t.untyped_storage())
