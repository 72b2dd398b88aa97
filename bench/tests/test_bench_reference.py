"""The benchmark's frozen reference against the program, on the CPU: the
generators node for node, the features and edges array for array, the
forward against the program's plain ``ref`` backend within float32
rounding, the bfs partition and its 1-hop re-growth against the program's,
and the budget's partition count against the program's router."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from bench.runners import gnn as runner  # noqa: E402
from bench.reference import generators as G  # noqa: E402
from bench.reference import model as ref  # noqa: E402
from repro_torch.core import aig as A  # noqa: E402
from repro_torch.core import gnn, pipeline  # noqa: E402
from repro_torch.core.features import groot_features  # noqa: E402
from repro_torch.core.partition import bfs_stripe_partition  # noqa: E402
from repro_torch.core.regrowth import extract_partitions  # noqa: E402
from repro_torch.exec.plan import choose_k  # noqa: E402
from repro_torch.kernels.ops import padded_shape  # noqa: E402

GNN = {"in_features": 4, "hidden": 32, "num_layers": 4, "num_classes": 5}
PROGRAM = {"csa": A.csa_multiplier, "booth": A.booth_multiplier}


def _aig(d: dict) -> A.AIG:
    return A.AIG(name=d["name"], kind=d["kind"], fanin0=d["fanin0"], fanin1=d["fanin1"],
                 label=d["label"], n_pi=d["n_pi"], pos=d["pos"])


def _tensors(d: dict):
    kind, f0, f1 = (torch.as_tensor(d[k]) for k in ("kind", "fanin0", "fanin1"))
    return ref.features(kind, f0, f1), ref.edges(kind, f0, f1)


@pytest.mark.parametrize("gen", ["csa", "booth"])
@pytest.mark.parametrize("bits", [8, 16, 32, 64])
def test_frozen_generator_equals_the_program_node_for_node(gen, bits):
    frozen, program = G.GENERATORS[gen](bits), PROGRAM[gen](bits)
    assert frozen["name"] == program.name and frozen["n_pi"] == program.n_pi
    for key in ("kind", "fanin0", "fanin1", "label", "pos"):
        np.testing.assert_array_equal(frozen[key], getattr(program, key), err_msg=key)


@pytest.mark.parametrize("gen", ["csa", "booth"])
def test_features_and_edges_equal_the_program(gen):
    d = G.GENERATORS[gen](16)
    x, (src, dst, slot, inv) = _tensors(d)
    np.testing.assert_array_equal(x.numpy(), groot_features(_aig(d)))
    g = _aig(d).to_edge_graph()
    mine = sorted(zip(src.tolist(), dst.tolist(), slot.tolist(), inv.tolist()))
    theirs = sorted(zip(g.edge_src.tolist(), g.edge_dst.tolist(), g.edge_slot.tolist(),
                        g.edge_inv.astype(int).tolist()))
    assert mine == theirs


@pytest.mark.parametrize("gen", ["csa", "booth"])
@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_forward_equals_the_programs_ref_backend(gen, seed):
    d = G.GENERATORS[gen](16)
    params = runner.make_params(GNN, seed, torch.device("cpu"))
    x, (src, dst, slot, inv) = _tensors(d)
    want = ref.forward(params, x, src, dst, slot, inv, x.shape[0])
    model = gnn.params_from_numpy(runner._numpy_tree(params))
    g = _aig(d).to_edge_graph()
    t = gnn.graph_tensors(g, "cpu")
    got = gnn.forward(model, torch.as_tensor(groot_features(_aig(d))), *t, num_nodes=g.num_nodes)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert runner.logit_gap(want, got.argmax(1).numpy()) <= 1e-5


def test_tf32_control_moves_the_logits():
    d = G.csa(16)
    params = runner.make_params(GNN, 3, torch.device("cpu"))
    x, (src, dst, slot, inv) = _tensors(d)
    f32 = ref.forward(params, x, src, dst, slot, inv, x.shape[0])
    tf32 = ref.forward(params, x, src, dst, slot, inv, x.shape[0], tf32=True)
    assert 1e-5 < float((f32 - tf32).abs().max()) < 1e-1


@pytest.mark.parametrize("k", [1, 3, 4, 7])
def test_stripes_and_regrowth_equal_the_programs(k):
    d = G.csa(16)
    _, (src, dst, _, _) = _tensors(d)
    g = _aig(d).to_edge_graph()
    n = g.num_nodes
    part = ref.stripes(n, k, "cpu")
    np.testing.assert_array_equal(part.numpy(), bfs_stripe_partition(g, k))
    subs = extract_partitions(g, part.numpy().astype(np.int32), regrow=True, hops=1)
    assert len(subs) == int(part.max()) + 1
    for p, sg in enumerate(subs):
        core, halo, keep = ref.regrown(part, src, dst, p)
        ids = torch.cat([core, halo]).numpy()
        np.testing.assert_array_equal(ids, sg.global_ids)
        assert core.numel() == sg.num_core
        mine = sorted(zip(src[keep].tolist(), dst[keep].tolist()))
        theirs = sorted(zip(sg.global_ids[sg.edge_src].tolist(),
                            sg.global_ids[sg.edge_dst].tolist()))
        assert mine == theirs


def test_partitioned_logits_agree_with_the_programs_partitioned_loop():
    d = G.csa(16)
    params = runner.make_params(GNN, 5, torch.device("cpu"))
    x, (src, dst, slot, inv) = _tensors(d)
    part = ref.stripes(x.shape[0], 4, "cpu")
    want = ref.partitioned_logits(params, x, src, dst, slot, inv, part)
    g = _aig(d).to_edge_graph()
    subs = extract_partitions(g, part.numpy().astype(np.int32), regrow=True, hops=1)
    got = gnn.predict_partitioned_loop(gnn.params_from_numpy(runner._numpy_tree(params)),
                                       subs, groot_features(_aig(d)), g.num_nodes, "ref",
                                       device="cpu")
    assert runner.logit_gap(want, got) <= 1e-5
    full = ref.forward(params, x, src, dst, slot, inv, x.shape[0])
    assert float((full - want).abs().max()) > 1e-3   # re-growth of one hop is not exact


def test_memory_model_and_padding_equal_the_programs():
    cfg = gnn.GNNConfig()
    for n, e in ((2110, 4124), (8_416_313, 16_826_482), (1, 0)):
        assert ref.memory_model_bytes(n, e, GNN) == pipeline.memory_model_bytes(n, e, cfg)
        assert ref.padded_shape(n, e, 64, 128) == padded_shape(n, e, min_nodes=64,
                                                               min_edges=128)
    for budget in (10**6, 1_716_000_000, 6 * 10**9):
        assert ref.estimated_k(8_416_313, 16_826_482, GNN, budget, capacity=2, halo_frac=0.15,
                               min_nodes=64, min_edges=128) == choose_k(
            8_416_313, 16_826_482, cfg, budget, capacity=2)


@pytest.mark.parametrize("bits,share", [(16, 2), (32, 3), (32, 6)])
def test_budget_partition_count_equals_the_programs(bits, share):
    d = G.csa(bits)
    _, (src, dst, _, _) = _tensors(d)
    n = d["kind"].shape[0]
    budget = ref.memory_model_bytes(n, src.numel(), GNN) // share
    mix = {"memory_budget_bytes": budget, "stream_capacity": 2, "regrow_hops": 1,
           "min_nodes": 64, "min_edges": 128}
    _, k = ref.budget_partition(n, src, dst, GNN, mix)
    prep = pipeline.prepare(pipeline.PipelineConfig(
        partitioner="bfs", memory_budget_bytes=budget, stream_capacity=2), _aig(d))
    assert k == (prep.num_partitions if prep.subgraphs else 1)
