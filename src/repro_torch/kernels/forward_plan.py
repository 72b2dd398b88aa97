"""Forward-invariant hoisting: everything a GNN forward reuses across layers.

Port of ``repro/kernels/forward_plan.py``.  A :class:`ForwardPlan` holds both
direction plans (fanin/fanout) and their concatenated edge-id streams, so
:meth:`ForwardPlan.stage_in` / :meth:`ForwardPlan.stage_out` stage each
direction's group-weight streams ONCE per forward (optionally narrowed to a
``stream_dtype``; kernels accumulate in f32), and :meth:`ForwardPlan.pad_x`
stages activations once per layer for both direction walks.  The port pads
no feature lanes, so the weight stacks need no padding either.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.groot_spmm import (
    SpmmPlan,
    StagedWeights,
    pad_features,
    plan_cat_eids,
    stage_group_weights,
)


@dataclasses.dataclass(frozen=True, eq=False)
class ForwardPlan:
    """Layer-invariant staging schedule for one graph (identity-hashed, as
    the cached instance is shared by every pair built on the graph)."""

    in_plan: SpmmPlan
    out_plan: SpmmPlan
    in_cat_eids: np.ndarray      # int32 concat of fanin bucket + HD eids
    out_cat_eids: np.ndarray

    def stage_in(self, wg: torch.Tensor, *, dtype=None) -> StagedWeights:
        """Gather the (E, 4) fanin group weights into kernel layout once."""
        return stage_group_weights(self.in_plan, wg, dtype=dtype)

    def stage_out(self, wg: torch.Tensor, *, dtype=None) -> StagedWeights:
        """Gather the (E, 2) fanout group weights into kernel layout once."""
        return stage_group_weights(self.out_plan, wg, dtype=dtype)

    @staticmethod
    def pad_x(x: torch.Tensor) -> torch.Tensor:
        """(N, F) -> (N + 1, F): one pad per layer, shared by both walks."""
        return pad_features(x)


def build_forward_plan(in_plan: SpmmPlan, out_plan: SpmmPlan) -> ForwardPlan:
    """Assemble the hoisting schedule from a graph's two direction plans."""
    assert in_plan.num_nodes == out_plan.num_nodes
    assert in_plan.num_edges == out_plan.num_edges
    return ForwardPlan(
        in_plan=in_plan,
        out_plan=out_plan,
        in_cat_eids=plan_cat_eids(in_plan),
        out_cat_eids=plan_cat_eids(out_plan),
    )
