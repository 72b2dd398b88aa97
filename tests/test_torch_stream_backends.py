"""The port's streamed route against the reference's, part 2: streamed
predictions equal to the port's own sequential loop bit for bit (the padding
contract keeps every real row's arithmetic) and to the reference's streamed
predictions (its ``groot`` kernels in Pallas interpret mode), on every
backend, capacity and prefetch depth.  Inputs and fixtures:
``torch_stream_common.py``.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from torch_stream_common import *  # noqa: E402,F401,F403 — shared imports and fixtures


# ---------------------------------------------------------------------------
# Streamed predictions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [0, 1])
@pytest.mark.parametrize("capacity", [1, 2, 3])
@pytest.mark.parametrize("backend", ["ref", "groot"])
def test_stream_equals_loop_and_reference(csa12, subgraphs, model, ref_streamed, backend,
                                          capacity, prefetch):
    """``stream_predict_partitioned`` equals the port's sequential loop bit
    for bit and the reference's streamed run."""
    g, feats = csa12
    got = TS.stream_predict_partitioned(model, subgraphs, feats, g.num_nodes, backend,
                                        capacity=capacity, prefetch=prefetch, device="cpu")
    loop = TG.predict_partitioned_loop(model, subgraphs, feats, g.num_nodes, backend,
                                       device="cpu")
    assert_same(got, loop)
    assert_same(got, ref_streamed(backend, capacity))


@pytest.mark.parametrize("backend", ["onehot", "groot_mxu", "groot_fused"])
def test_stream_equals_loop_on_the_other_backends(csa12, subgraphs, model, backend):
    g, feats = csa12
    assert_same(TS.stream_predict_partitioned(model, subgraphs, feats, g.num_nodes, backend,
                                              device="cpu"),
                TG.predict_partitioned_loop(model, subgraphs, feats, g.num_nodes, backend,
                                            device="cpu"))


def test_predict_partitioned_shim_warns_and_routes(csa12, subgraphs, model):
    g, feats = csa12
    loop = TG.predict_partitioned_loop(model, subgraphs, feats, g.num_nodes, "groot",
                                       device="cpu")
    for streaming in (True, False):
        with pytest.warns(DeprecationWarning, match="predict_partitioned is deprecated"):
            got = TG.predict_partitioned(model, subgraphs, feats, g.num_nodes, "groot",
                                         streaming=streaming, device="cpu")
        assert_same(got, loop)
