"""Data pipelines (port of ``repro/training/data.py``).

Token pipeline: a deterministic, restart-reproducible synthetic LM stream
(a numpy PRNG seeded per (seed, step, host)) with the structure of a sharded
corpus reader: each host materialises only its slice of the global batch,
and the stream can be fast-forwarded to any step in O(1) (checkpoint-restart
resumes the data order exactly).  The stream carries a learnable signature
(a repeating n-gram), so a correct training pipeline visibly drops the loss
within a few steps.  Host numpy only, bit-equal to the reference's.

Graph pipeline: the GROOT verification side (``GraphBatch``,
``graph_batch``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    structure: int = 8   # n-gram period of the synthetic signal (0 = iid)


class TokenStream:
    """Deterministic O(1)-seekable synthetic token batches."""

    def __init__(self, cfg: TokenStreamConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not split over "
                             f"{cfg.n_hosts} hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts

    def batch_at(self, step: int) -> np.ndarray:
        """(local_batch, seq_len + 1) int32 — inputs+labels window."""
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
        b, s = self.local_batch, cfg.seq_len + 1
        if not cfg.structure:
            return rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int64).astype(np.int32)
        # structured stream: one global random n-gram (fixed per seed),
        # repeated with a per-sequence phase roll and 5% corruption
        period = cfg.structure
        base_rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 7]))
        base = base_rng.integers(0, cfg.vocab_size, period, dtype=np.int64)
        reps = -(-s // period) + 1
        row = np.tile(base, reps)
        offs = rng.integers(0, period, b)
        seq = np.stack([row[o: o + s] for o in offs])
        noise = rng.random((b, s)) < 0.05  # 5% corruption
        seq[noise] = rng.integers(0, cfg.vocab_size, int(noise.sum()))
        return seq.astype(np.int32)

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


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
