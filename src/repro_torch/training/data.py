"""Host graph batches for training (port of ``repro/training/data.py``'s
graph pipeline: ``GraphBatch``, ``graph_batch``).  The reference's
``TokenStream`` serves the zoo's training and is not ported (ROADMAP
Queue 1, item 8)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class GraphBatch:
    x: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_inv: Optional[np.ndarray]
    edge_slot: Optional[np.ndarray]
    labels: np.ndarray


def graph_batch(dataset: str, bits: int, seed: int = 0) -> GraphBatch:
    from repro_torch.core import aig as A
    from repro_torch.core.features import groot_features

    design = A.make_design(dataset, bits, seed=seed)
    g = design.to_edge_graph()
    return GraphBatch(
        x=groot_features(design),
        edge_src=g.edge_src,
        edge_dst=g.edge_dst,
        edge_inv=g.edge_inv,
        edge_slot=g.edge_slot,
        labels=np.asarray(design.label, np.int32),
    )
