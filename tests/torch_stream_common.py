"""Shared imports, inputs and fixtures of the port's streamed-route tests
(``test_torch_stream_pack.py``, ``test_torch_stream_backends.py``,
``test_torch_stream_faults.py``): csa-12 cut 4 ways (multilevel), the
shipped params on both packages, and the reference's streamed predictions.
Test modules import it after ``pytest.importorskip("torch")``."""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest

import torch  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import faults as RF  # noqa: E402
from repro.api import Session as RefSession  # noqa: E402
from repro.core import gnn as RG  # noqa: E402
from repro.core import pipeline as RPL  # noqa: E402
from repro.core.graph import EdgeGraph as RefEdgeGraph  # noqa: E402
from repro.exec import packing as RK  # noqa: E402
from repro.exec import plan as RX  # noqa: E402
from repro.exec import stream as RS  # noqa: E402
from repro.service import bucketing as RB  # noqa: E402
from repro_torch import faults as TF  # noqa: E402
from repro_torch.api import Session  # noqa: E402
from repro_torch.core import aig as A  # noqa: E402
from repro_torch.core import gnn as TG  # noqa: E402
from repro_torch.core import partition as TP  # noqa: E402
from repro_torch.core import pipeline as P  # noqa: E402
from repro_torch.core import regrowth as TR  # noqa: E402
from repro_torch.core.features import groot_features  # noqa: E402
from repro_torch.core.graph import EdgeGraph, batch_graphs  # noqa: E402
from repro_torch.exec import packing as TK  # noqa: E402
from repro_torch.exec import plan as TX  # noqa: E402
from repro_torch.exec import stream as TS  # noqa: E402
from repro_torch.kernels import groot_spmm as gs  # noqa: E402
from repro_torch.kernels import plan_cache as pc  # noqa: E402
from repro_torch.service import bucketing as TB  # noqa: E402
from repro_torch.service.scheduler import BucketRunner  # noqa: E402

NPZ = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "data" / "groot_csa8.npz"


def assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def as_ref(g: EdgeGraph) -> RefEdgeGraph:
    return RefEdgeGraph(g.num_nodes, g.edge_src, g.edge_dst, g.edge_inv, g.edge_slot)


@pytest.fixture(scope="module")
def csa12():
    d = A.make_design("csa", 12)
    return d.to_edge_graph(), groot_features(d)


@pytest.fixture(scope="module")
def params():
    return TG.load_params(NPZ)


@pytest.fixture(scope="module")
def model(params):
    return TG.params_from_numpy(params)


@pytest.fixture(scope="module")
def ref_params(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


@pytest.fixture(scope="module")
def subgraphs(csa12):
    g, _ = csa12
    return TR.extract_partitions(g, TP.multilevel_partition(g, 4))


@pytest.fixture(scope="module")
def ref_streamed(csa12, subgraphs, ref_params):
    """The reference's streamed predictions at csa-12 k=4, one run per
    (backend, capacity), computed on first use."""
    g, feats = csa12
    rsubs = RX.build_partition_plan(as_ref(g), 4, use_cache=False).subgraphs
    runs = {}

    def get(backend, capacity):
        if (backend, capacity) not in runs:
            runs[backend, capacity] = RS.StreamingExecutor(
                ref_params, backend, capacity=capacity, prefetch=0,
            ).run_subgraphs(list(rsubs), feats, g.num_nodes)
        return runs[backend, capacity]

    return get


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small graphs run far faster on one thread than on a contended pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
