"""The frozen operation and byte counts against counts made by hand."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from bench import counts, peaks  # noqa: E402

GNN = {"in_features": 4, "hidden": 32, "num_layers": 4, "num_classes": 5}


def test_model_flops_of_a_six_node_graph():
    # 6 nodes, 7 edges.  A layer: 7 products of (6, F) x (F, 32), two
    # directions' means over 7 edges, 7 adds a node and feature; the head
    layer0 = 7 * 2 * 6 * 4 * 32 + 2 * 2 * 7 * 4 + 7 * 6 * 32          # 12,208
    layer = 7 * 2 * 6 * 32 * 32 + 2 * 2 * 7 * 32 + 7 * 6 * 32         # 88,256
    head = 2 * 6 * 32 * 5 + 6 * 5                                      # 1,950
    assert layer0 + 3 * layer + head == 278_926
    assert counts.model_flops(6, 7, GNN) == 278_926


def test_six_node_graph_has_only_ld_rows():
    src = np.array([0, 1, 0, 2, 1, 2, 3])
    dst = np.array([2, 2, 3, 3, 4, 4, 5])
    got = counts.spmm_counts(src, dst, 6, GNN)
    assert got["hd"]["launches"] == 0 and got["hd"]["bytes"] == 0
    # fanin (G=4): 7 edges, 4 rows written (2,3,4,5), 4 rows of h read (0-3);
    # fanout (G=2): 7 edges, 4 rows written (0-3), 4 rows read (2-5)
    fanin = [4 * (4 * f + 7 + 7 * 4 + 4 * 4 * f) for f in (4, 32, 32, 32)]
    fanout = [4 * (4 * f + 7 + 7 * 2 + 4 * 2 * f) for f in (4, 32, 32, 32)]
    assert got["ld"]["bytes"] == sum(fanin) + sum(fanout)
    assert got["ld"]["flops"] == sum(2 * 7 * 4 * f + 2 * 7 * 2 * f for f in (4, 32, 32, 32))
    assert got["ld"]["launches"] == 8


def test_a_row_of_degree_513_is_hd():
    # a star: node 0 drives nodes 1..513.  Fanout row 0 has 513 edges (HD);
    # every fanin row has one (LD)
    n = 514
    src = np.zeros(513, dtype=np.int64)
    dst = np.arange(1, 514)
    got = counts.spmm_counts(src, dst, n, GNN)
    assert got["ld"]["bytes"] == 43_108 + 3 * 273_044
    assert got["ld"]["flops"] == 16_416 + 3 * 131_328
    assert got["hd"]["bytes"] == 14_396 + 3 * 72_076
    assert got["hd"]["flops"] == 8_208 + 3 * 65_664
    assert got["ld"]["launches"] == got["hd"]["launches"] == 4
    want = sum(max(b / peaks.HBM_BYTES_PER_S, f / peaks.F32_FLOPS)
               for b, f in ((14_396, 8_208), (72_076, 65_664), (72_076, 65_664),
                            (72_076, 65_664)))
    assert got["hd"]["t_min"] == pytest.approx(want, rel=1e-12)


def test_the_threshold_row_of_degree_512_is_ld():
    src = np.zeros(512, dtype=np.int64)
    dst = np.arange(1, 513)
    got = counts.spmm_counts(src, dst, 513, GNN)
    assert got["hd"]["launches"] == 0
