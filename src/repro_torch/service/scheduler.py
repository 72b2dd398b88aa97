"""The bucketed device runner of packed batches (port of ``BucketRunner``
from ``repro/service/scheduler.py``).

:class:`BucketRunner` runs one packed batch (``bucketing.pack_batch``'s
arrays) through the padded GNN forward and returns its int32 predictions.
Backends come in two classes, as in the reference:

  * **shape-stable** ("ref", "onehot"): the work depends on the padded
    shape only.  The reference compiles one executable per (bucket,
    capacity) signature; the port has no jit, so ``compile_count`` counts
    the first sight of each signature — what the reference would trace.
  * **structure-keyed** (the ``groot*`` backends): each packed batch's
    degree-bucketed plans depend on its structure.  Host plans come from
    the process-wide structural ``PLAN_CACHE`` (a recurring structure
    builds nothing; ``compile_count`` counts the plan builds), keyed by
    ``plan_cache.structure_keys`` that the streaming executor hashes on its
    prefetch thread.  The runner holds the device copies (edge tensors and
    plan indices) of ONE packed structure at a time: a batch of the same
    structure reuses them, a different structure first releases them
    (``ops.release_device``), and :meth:`release` drops them after a run.
    Cached pairs would keep every structure's indices on the card.

The reference's ``ShapeBucketScheduler``, ``SlotPool`` and the runner's
warmup bookkeeping belong to the service route, which is not ported yet
(ROADMAP Queue 1, item 6).
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.core import gnn
from repro_torch.kernels import ops
from repro_torch.kernels.plan_cache import PLAN_CACHE, structure_keys

SHAPE_STABLE_BACKENDS = ("ref", "onehot")
STRUCTURE_KEYED_BACKENDS = ("groot", "groot_mxu", "groot_fused")


class BucketRunner:
    """One padded GNN forward per packed batch; counts compiles and calls."""

    def __init__(self, params: gnn.GrootGNN, backend: str = "ref", *,
                 stream_dtype: Optional[str] = None, device=None):
        if backend not in SHAPE_STABLE_BACKENDS + STRUCTURE_KEYED_BACKENDS:
            raise ValueError(
                f"runner backend must be one of {SHAPE_STABLE_BACKENDS} "
                f"(shape-stable) or {STRUCTURE_KEYED_BACKENDS} "
                f"(structure-keyed, via the plan cache), got {backend!r}"
            )
        self.params = params
        self.backend = backend
        self.device = gnn._params_on(params, device)
        # edge-stream dtype for the hoisted groot* forward (None/f32 =
        # bit-exact staging; "bfloat16" halves the staged stream bytes)
        self._stream_dtype = stream_dtype
        self.compile_count = 0
        self.run_count = 0
        self._signatures: set = set()
        # (gkeys, edge_src, edge_dst, pair) of the structure held on the device
        self._held: Optional[tuple] = None
        self._lock = threading.Lock()

    @property
    def structure_keyed(self) -> bool:
        return self.backend in STRUCTURE_KEYED_BACKENDS

    def release(self) -> None:
        """Drop the held structure's device copies (its host plans stay in
        the plan cache)."""
        with self._lock:
            self._drop()

    def _drop(self) -> None:
        if self._held is not None:
            ops.release_device(self._held[3])
            self._held = None

    def _edges(self, batch: dict) -> tuple:
        return tuple(torch.from_numpy(batch[k]).to(self.device).long()
                     for k in ("edge_src", "edge_dst"))

    def _structure(self, batch: dict, gkeys) -> tuple:
        """(edge_src, edge_dst, pair) of the batch's structure on the device."""
        if self._held is not None and self._held[0] == gkeys:
            return self._held[1:]
        self._drop()
        builds = PLAN_CACHE.snapshot().builds
        src, dst = self._edges(batch)
        pair = ops.make_agg_pair(batch["edge_src"], batch["edge_dst"], batch["num_nodes"],
                                 self.backend, device=self.device, cache=False, gkeys=gkeys)
        self.compile_count += PLAN_CACHE.snapshot().builds - builds
        self._held = (gkeys, src, dst, pair)
        return src, dst, pair

    def __call__(self, batch: dict, gkeys: Optional[tuple] = None) -> np.ndarray:
        """Predictions (int32, one a packed row) of one packed batch.
        ``gkeys`` are the batch's ``structure_keys`` where the caller has
        them (structure-keyed backends hash the batch otherwise)."""
        num_nodes = batch["num_nodes"]
        with self._lock:  # one device stream; keeps the probes race-free
            self.run_count += 1
            if self.structure_keyed:
                if gkeys is None:
                    gkeys = structure_keys(batch["edge_src"], batch["edge_dst"], num_nodes)
                src, dst, agg = self._structure(batch, gkeys)
            else:
                sig = (batch["x"].shape, batch["edge_src"].shape, num_nodes)
                if sig not in self._signatures:
                    self._signatures.add(sig)
                    self.compile_count += 1
                src, dst = self._edges(batch)
                agg = None if self.backend == "ref" else ops.make_agg_pair(
                    batch["edge_src"], batch["edge_dst"], num_nodes, self.backend,
                    device=self.device, cache=False)
            x, inv, slot = (torch.from_numpy(batch[k]).to(self.device)
                            for k in ("x", "edge_inv", "edge_slot"))
            with torch.no_grad():
                logits = gnn.forward(self.params, x, src, dst, inv, slot,
                                     num_nodes=num_nodes, agg=agg,
                                     stream_dtype=self._stream_dtype)
            return logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
