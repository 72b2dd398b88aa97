"""The dry run's shapes and shardings against the reference's, exactly:
``abstract``/``logical_axes``, ``input_specs``, the ``groot-gnn`` config and
the registry order, ``make_rules``/``partition_spec`` for every leaf of every
arch on the production and test meshes (fsdp on and off),
``cache_shardings``, ``groot_graph_dims``, and ``build_cell``'s static meta
and in/out specs on a (2, 4) mesh.

The reference's ``make_rules`` and ``partition_spec`` read only a mesh's
``axis_names`` and ``shape``, so a stand-in object serves on its side; the
port's side runs on a fake process group (``launch/dryrun.py:fake_world``)
and a ``DeviceMesh``.  The reference's cells need 8 devices: a subprocess
with 8 host devices builds them on a ``jax.sharding.Mesh`` (Auto axes: under
jax 0.9 ``jax.make_mesh``'s Explicit axes make its ``shard()`` raise,
ROADMAP Queue 3).  The port keeps its decode cache one dict a layer where
the reference stacks each super-block's caches, and its serving params one
dict a layer where the reference stacks them: those compare as multisets of
specs, a stacked leaf counted once a layer with its ``layers`` entry (never
sharded) dropped.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import steps as RS  # noqa: E402
from repro.sharding import rules as RR  # noqa: E402
from repro.zoo import configs as RC  # noqa: E402
from repro.zoo.configs import base as RB  # noqa: E402
from repro.zoo.configs import shapes as RSH  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.dryrun import fake_world  # noqa: E402
from repro_torch.sharding import rules as TR  # noqa: E402
from repro_torch.zoo import configs as TC  # noqa: E402
from repro_torch.zoo.configs import base as TB  # noqa: E402
from repro_torch.zoo.configs import shapes as TSH  # noqa: E402
from repro_torch.zoo.models.attention import KVCache  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
LM = tuple(RC.LM_ARCHS)
MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 4): ("data", "model"), (1, 1): ("data", "model")}


def _axes_leaves(tree) -> list:
    """Leaves of a tree whose leaves are tuples (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _axes_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _axes_leaves(t)]
    return [] if tree is None else [tree]


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", LM)
def test_abstract_and_logical_axes(arch, smoke):
    """Leaf for leaf: the meta tensors' shapes and dtypes are the
    ``ShapeDtypeStruct``s', the logical axes the same tuples."""
    rspec = RB.model_spec_tree(RC.get_config(arch, smoke=smoke))
    tspec = TB.model_spec_tree(TC.get_config(arch, smoke=smoke))
    for rdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jax.tree.leaves(RB.abstract(rspec, rdt))
        got = TB.leaves(TB.abstract(tspec, tdt))
        assert [tuple(w.shape) for w in want] == [tuple(g.shape) for g in got]
        assert all(g.device.type == "meta" and g.dtype == tdt for g in got)
        assert all(w.dtype == rdt for w in want)
    want = jax.tree.leaves(RB.logical_axes(rspec), is_leaf=lambda x: isinstance(x, tuple))
    assert _axes_leaves(TB.logical_axes(tspec)) == list(want)


def _unstacked(tree) -> list:
    """(shape, dtype) of every array leaf of a reference cache tree, a
    stacked super-block leaf once a layer (its leading dim dropped); the 0-d
    ``pos`` counters skipped."""
    out = []
    blocks = tree.get("blocks") or []
    for b in blocks:
        for leaf in jax.tree.leaves(b):
            if leaf.ndim > 1:
                out += [(tuple(leaf.shape[1:]), str(leaf.dtype))] * leaf.shape[0]
    for leaf in jax.tree.leaves(tree.get("tail") or []):
        if leaf.ndim:
            out.append((tuple(leaf.shape), str(leaf.dtype)))
    return out


def _port_cache_leaves(cache) -> list:
    out = []

    def walk(node):
        if isinstance(node, KVCache):
            walk(node.k)
            walk(node.v)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list):
            for x in node:
                walk(x)
        elif isinstance(node, torch.Tensor):
            out.append((tuple(node.shape), str(node.dtype).replace("torch.", "")))

    walk(cache)
    return out


@pytest.mark.parametrize("arch", LM)
def test_input_specs(arch):
    """Every supported shape: tokens and the stub encoder input exactly; the
    decode cache leaf for leaf once the reference's super-blocks are
    unstacked."""
    rc, tc = RC.get_config(arch), TC.get_config(arch)
    assert RSH.supported_shapes(rc) == TSH.supported_shapes(tc)
    assert {k: dataclasses.astuple(v) for k, v in RSH.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in TSH.SHAPES.items()}
    for shape in TSH.supported_shapes(tc):
        want, got = RSH.input_specs(rc, shape), TSH.input_specs(tc, shape)
        assert sorted(want) == sorted(got)
        for k in want:
            if k == "cache":
                w = collections.Counter(_unstacked(want[k]))
                g = collections.Counter(_port_cache_leaves(got[k]))
                assert w == g
            else:
                assert tuple(want[k].shape) == tuple(got[k].shape)
                assert str(want[k].dtype) == str(got[k].dtype).replace("torch.", "")
                assert got[k].device.type == "meta"


def test_groot_config_and_registry_order():
    """groot-gnn's config fields (its GNN's too) and the registry's order."""
    assert list(TC.ARCHS) == list(RC.ARCHS)
    assert list(TC.LM_ARCHS) == list(RC.LM_ARCHS)
    for smoke in (False, True):
        r, t = RC.get_config("groot-gnn", smoke), TC.get_config("groot-gnn", smoke)
        rd = {f.name: getattr(r, f.name) for f in dataclasses.fields(r) if f.name != "gnn"}
        td = {f.name: getattr(t, f.name) for f in dataclasses.fields(t) if f.name != "gnn"}
        assert rd == td
        # the port's GNNConfig has no ``dtype`` (its forward takes the inputs'):
        # every field it has equals the reference's
        rg, tg = dataclasses.asdict(r.gnn), dataclasses.asdict(t.gnn)
        assert set(tg) <= set(rg) and {k: rg[k] for k in tg} == tg


class StandIn:
    """What the reference's rules read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


@pytest.mark.parametrize("mesh_shape", list(MESHES))
def test_rules_and_partition_specs(mesh_shape):
    """``make_rules`` (fsdp on/off) gives the reference's dict, and
    ``partition_spec`` its entries for every leaf of every arch's spec tree
    (full configs), the placements of the port's ``sharding_for_spec`` read
    back to the same spec."""
    from torch.distributed.device_mesh import init_device_mesh

    names = MESHES[mesh_shape]
    ref_mesh = StandIn(mesh_shape, names)
    with fake_world(int(np.prod(mesh_shape))):
        mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=names)
        for fsdp in (False, True):
            rr, tr = RR.make_rules(ref_mesh, fsdp=fsdp), TR.make_rules(mesh, fsdp=fsdp)
            assert rr == tr
            for arch in LM:
                rspec = jax.tree.leaves(RB.model_spec_tree(RC.get_config(arch)),
                                        is_leaf=lambda x: isinstance(x, RB.ParamSpec))
                tspec = TB.leaves(TB.model_spec_tree(TC.get_config(arch)))
                for r, t in zip(rspec, tspec):
                    want = tuple(RR.partition_spec(r.shape, r.axes, ref_mesh, rr))
                    got = TR.partition_spec(t.shape, t.axes, mesh, tr)
                    assert got == want, (arch, t)
                    place = TR.sharding_for_spec(t, mesh, tr)
                    assert _norm(TR.spec_of(place, len(t.shape), mesh)) == _norm(want)


def test_shard_is_identity_without_context():
    """The counterpart of the reference's ``test_shard_noop_without_ctx``."""
    x = torch.ones(4, 4)
    assert TR.shard(x, ("batch", None)) is x
    assert TR.current_ctx() is None


@pytest.mark.parametrize("arch", ["qwen3-8b", "whisper-base", "rwkv6-3b", "recurrentgemma-9b",
                                  "gemma2-9b"])
def test_cache_shardings(arch):
    """The decode cache's specs, leaf name by leaf name, against the
    reference's ``cache_shardings`` on a one-device mesh (every axis
    divides: the logical axes show whole)."""
    from jax.sharding import Mesh
    from torch.distributed.device_mesh import init_device_mesh

    rc, tc = RC.get_config(arch, smoke=True), TC.get_config(arch, smoke=True)
    rmesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    rcache = jax.eval_shape(lambda: RS.init_cache_tree(rc, 4, 64))
    rsh = RS.cache_shardings(rcache, rmesh, RR.make_rules(rmesh))
    want = collections.Counter()
    for path, s in jax.tree_util.tree_leaves_with_path(rsh):
        name = next(str(getattr(e, "name", getattr(e, "key", ""))) for e in reversed(path)
                    if isinstance(getattr(e, "name", getattr(e, "key", None)), str))
        if name == "pos":
            continue
        spec = tuple(s.spec)
        stacked = str(path[0].key) == "blocks"
        if stacked:  # once a layer, the super-block entry dropped
            n = jax.tree.leaves(rcache["blocks"])[0].shape[0]
            want[name, _norm(spec[1:])] += n
        else:
            want[name, _norm(spec)] += 1
    with fake_world(1):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        cache = TS.init_cache_tree(tc, 4, 64, device="meta")
        tsh = TS.cache_shardings(cache, mesh, TR.make_rules(mesh))
        got = collections.Counter()

        def walk(c, s, name=None):
            if isinstance(c, KVCache):
                walk(c.k, s.k, "k")
                walk(c.v, s.v, "v")
            elif isinstance(c, dict):
                for k in c:
                    walk(c[k], s[k], k)
            elif isinstance(c, list):
                for a, b in zip(c, s):
                    walk(a, b, name)
            else:
                got[name, _norm(TR.spec_of(s, c.dim(), mesh))] += 1

        walk(cache, tsh)
    assert got == want


def test_groot_graph_dims():
    for shape, (bits, batch) in RS.GROOT_SHAPES.items():
        assert TS.GROOT_SHAPES[shape] == (bits, batch)
        for parts in (1, 2, 8, 256, 512):
            assert TS.groot_graph_dims(bits, batch, parts) == RS.groot_graph_dims(bits, batch,
                                                                                  parts)


# ---------------------------------------------------------------------------
# build_cell on a (2, 4) mesh against the reference's (8 host devices)
# ---------------------------------------------------------------------------

CELL_ARCHS = ("qwen3-8b", "qwen3-moe-235b-a22b", "whisper-base", "groot-gnn")

REF_CELLS = """
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.zoo.configs import get_config
from repro.zoo.configs.shapes import supported_shapes
from repro.launch.steps import GROOT_SHAPES, build_cell, build_groot_cell

mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
out = {}
for arch in sys.argv[1].split(","):
    cfg = get_config(arch)
    shapes = list(GROOT_SHAPES) if arch == "groot-gnn" else supported_shapes(cfg)
    for shape in shapes:
        cell = (build_groot_cell if arch == "groot-gnn" else build_cell)(cfg, shape, mesh)
        leaves = lambda t: [[None if e is None else (list(e) if isinstance(e, tuple) else e)
                             for e in s.spec]
                            for s in jax.tree.leaves(t)]
        shapes_of = lambda t: [list(a.shape) for a in jax.tree.leaves(t)]
        out[f"{arch}/{shape}"] = dict(meta=cell.static_meta,
                                      ins=[leaves(x) for x in cell.in_shardings],
                                      in_shapes=[shapes_of(x) for x in cell.args],
                                      outs=leaves(cell.out_shardings))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_cells():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_CELLS),
                           ",".join(CELL_ARCHS)], capture_output=True, text=True, env=env,
                          timeout=240, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _norm(spec) -> tuple:
    """Specs in one form: a one-axis tuple as its name, trailing Nones
    dropped (``PartitionSpec()`` replicates every dim)."""
    out = []
    for e in spec:
        e = tuple(e) if isinstance(e, (list, tuple)) else e
        out.append(e[0] if isinstance(e, tuple) and len(e) == 1 else e)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _port_specs(args, shardings, mesh) -> list:
    """Specs of a cell's leaves (``KVCache`` k/v included, in leaf order)."""
    out = []

    def leaf(a, place):
        if isinstance(a, KVCache):
            leaf(a.k, place.k)
            leaf(a.v, place.v)
        elif isinstance(a, torch.Tensor):
            out.append(_norm(TR.spec_of(place, a.dim(), mesh)))

    TB.tree_map(leaf, args, shardings)
    return out


def _stacked_counts(specs, shapes, n_super, cache: bool) -> collections.Counter:
    """The reference's specs as a multiset, a leaf of ``n_super`` stacked
    layers counted once a layer with its leading entry dropped; in a cache,
    the ``pos`` counters (0-d, or one a stacked layer) skipped."""
    c = collections.Counter()
    for s, shp in zip(specs, shapes):
        if not shp or cache and len(shp) == 1 and shp[0] == n_super:
            continue
        if n_super and shp[0] == n_super and len(s) == len(shp) and s[0] is None:
            c[_norm(s[1:])] += n_super
        else:
            c[_norm(s)] += 1
    return c


@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_build_cell_specs(arch, ref_cells):
    """Static meta, and every in/out spec, against the reference's cells on
    a (2, 4) mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = TC.get_config(arch)
    shapes = list(TS.GROOT_SHAPES) if arch == "groot-gnn" else TSH.supported_shapes(cfg)
    with fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        for shape in shapes:
            want = ref_cells[f"{arch}/{shape}"]
            cell = (TS.build_groot_cell if arch == "groot-gnn" else TS.build_cell)(
                cfg, shape, mesh)
            assert cell.static_meta == want["meta"], shape
            kind = "groot" if arch == "groot-gnn" else TSH.SHAPES[shape].kind
            n_super = 0 if arch == "groot-gnn" else cfg.num_layers // cfg.pattern_period
            for i, (args, place) in enumerate(zip(cell.args, cell.in_shardings)):
                got = _port_specs(args, place, mesh)
                if kind in ("train", "groot") or i > 0 and kind == "prefill":
                    assert [_norm(s) for s in want["ins"][i]] == got, (shape, i)
                else:  # per-layer params / caches against stacked ones
                    assert _stacked_counts(want["ins"][i], want["in_shapes"][i],
                                           n_super if n_super > 1 else 0,
                                           kind == "decode" and i == 1) == \
                        collections.Counter(got), (shape, i)
            outs = cell.out_shardings
            if kind == "groot":
                assert [_norm(s) for s in want["outs"]] == [_norm(TR.spec_of(outs, 2, mesh))]
            elif kind == "train":
                got = _port_specs(cell.args[0], outs[0], mesh) + \
                    _port_specs(cell.args[1], outs[1], mesh) + \
                    [_norm(TR.spec_of(outs[2][k], 0, mesh)) for k in ("grad_norm", "loss")]
                assert [_norm(s) for s in want["outs"]] == got
            else:  # the logits' spec first; decode: the next token's before it
                head = [_norm(TR.spec_of(o, 2, mesh)) for o in outs[:-1]]
                assert [_norm(s) for s in want["outs"][:len(head)]] == head, shape
