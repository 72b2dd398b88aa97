"""Multi-pod dry run (port of ``repro/launch/dryrun.py``).

For every (architecture x input shape) and both production meshes this
traces the cell's step with full sharding assignments on fake tensors and
records the per-device cost (``roofline/counter.py``: dot FLOPs,
collective bytes by kind, traffic, argument bytes and the peak of live
bytes) as JSON artifacts under
``experiments/dryrun_torch/<mesh>/<arch>__<shape>.json``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape train_4k --mesh pod

Where the reference lowers and compiles for 512 placeholder host devices,
the port runs the step itself, eagerly, with nothing allocated and nothing
launched:

  * the ranks are a fake process group (``fake_world``: one process stands
    in for rank 0 of 256 or 512, every collective returns at once), opened
    by :func:`main` for each mesh and closed after it;
  * the params, optimizer state and inputs are fake DTensors on the
    production ``DeviceMesh`` (``launch/mesh.py:make_production_mesh``),
    placed by ``launch/steps.py``'s shardings;
  * the step runs under ``use_sharding`` inside a ``FakeTensorMode``, so
    DTensor issues the local ops and collectives each rank would, and the
    counter bills them.

``--device cuda`` (the default) traces the card's program: fake CUDA
tensors, so attention reaches K8 (its custom op's fake implementation; the
``k8_traced`` count) where the card would launch it.  It needs a CUDA build
of PyTorch but no card.  ``--device cpu`` traces the CPU program (the plain
attention path), which is what a CPU-only build can do.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.launch.mesh import PRODUCTION_MESHES, make_production_mesh
from repro_torch.launch.steps import GROOT_SHAPES, build_cell, build_groot_cell
from repro_torch.roofline.counter import CostCounter
from repro_torch.sharding.rules import is_dtensor, use_sharding
from repro_torch.zoo.configs import ARCHS, PORT_ARCHS, get_config
from repro_torch.zoo.configs.base import tree_map
from repro_torch.zoo.configs.shapes import supported_shapes
from repro_torch.zoo.models.attention import KVCache

ART_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
MESH_NAMES = {"pod": False, "multipod": True}


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    for the duration of the block (an initialised group of that size is
    used as it is)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"fake_world({world_size}): a process group of "
                               f"{dist.get_world_size()} ranks is already initialised")
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def world_size(mesh_name: str) -> int:
    shape, _ = PRODUCTION_MESHES[MESH_NAMES[mesh_name]]
    return int(torch.Size(shape).numel())


def materialize(args, shardings, mesh, device):
    """Fake DTensors for a tree of meta tensors and its placements: each
    rank's local shard allocated as a fake tensor on ``device`` (rank 0's,
    the largest, for an uneven split)."""
    from torch.distributed.tensor import DTensor

    def leaf(a, place):
        if isinstance(a, KVCache):
            return KVCache(leaf(a.k, place.k), leaf(a.v, place.v), a.pos, a.window)
        if not isinstance(a, torch.Tensor):
            return a
        local = list(a.shape)
        for i, p in enumerate(place):
            if p.is_shard():
                local[p.dim] = -(-local[p.dim] // mesh.size(i))
        t = torch.empty(local, dtype=a.dtype, device=device)
        return DTensor.from_local(t, mesh, place, run_check=False, shape=a.shape,
                                  stride=a.stride())

    return tree_map(leaf, args, shardings)


def _tensor_leaves(tree) -> list:
    """The tensors of an argument tree, a ``KVCache``'s ``k`` and ``v``
    included."""
    out: list = []

    def leaf(a):
        if isinstance(a, KVCache):
            out.extend((a.k, a.v))
        elif isinstance(a, torch.Tensor):
            out.append(a)

    tree_map(leaf, tree)
    return out


def _is_place(s) -> bool:
    from torch.distributed.tensor import Placement

    return isinstance(s, tuple) and len(s) > 0 and all(isinstance(p, Placement) for p in s)


def _constrain(out, shardings) -> None:
    """Move the outputs to the cell's out shardings (the collectives a
    jitted step's ``out_shardings`` would add)."""
    if shardings is None:
        return
    if _is_place(shardings):
        if is_dtensor(out) and tuple(out.placements) != shardings:
            out.redistribute(out.device_mesh, shardings)
    elif isinstance(out, KVCache):
        _constrain(out.k, shardings.k)
        _constrain(out.v, shardings.v)
    elif isinstance(out, dict):
        for k, v in out.items():
            _constrain(v, shardings.get(k))
    elif isinstance(out, (list, tuple)):
        for o, s in zip(out, shardings):
            _constrain(o, s)


def trace(cell, mesh, device) -> tuple:
    """Run ``cell``'s step on fake DTensors under the counter: (stats,
    seconds, K8 calls traced)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    k8 = fa.flash_attention.traced
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = materialize(cell.args, cell.in_shardings, mesh, device)
        step_args = cell.prepare(*args) if cell.prepare else args
        grad = cell.static_meta.get("optimizer") is not None
        with torch.set_grad_enabled(grad), use_sharding(
                mesh, fsdp=cell.static_meta.get("fsdp", False),
                sp=cell.static_meta.get("sp", False)), CostCounter(_tensor_leaves(args)) as counter:
            out = cell.step_fn(*step_args)
            _constrain(out, cell.out_shardings)
            del out
        del args, step_args
    return counter.stats, time.perf_counter() - t0, fa.flash_attention.traced - k8


def run_cell(cell, mesh, mesh_name: str, save: bool = True, device: str = "cuda",
             art_dir: Path = ART_DIR) -> dict:
    stats, secs, k8 = trace(cell, mesh, device)
    record = {
        "arch": cell.arch,
        "shape": cell.shape,
        "mesh": mesh_name,
        "devices": int(mesh.size()),
        "device_type": device,
        "meta": cell.static_meta,
        "timing": {"trace_s": round(secs, 2)},
        "memory_analysis": {
            "argument_size_in_bytes": int(stats.entry_param_bytes),
            "peak_bytes": int(stats.peak_bytes),
        },
        "hlo": {
            "dot_flops_per_device": stats.dot_flops,
            "collective_bytes_per_device": stats.collective_bytes,
            "collective_by_kind": stats.collective_by_kind,
            "traffic_bytes_per_device": stats.traffic_bytes,
            "entry_param_bytes_per_device": stats.entry_param_bytes,
            "ops": stats.ops,
        },
        "k8_traced": k8,
        "param_bytes_per_device": local_bytes(cell.args[0], cell.in_shardings[0], mesh),
    }
    if save:
        out = Path(art_dir) / mesh_name
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{cell.arch}__{cell.shape}.json"
        path.write_text(json.dumps(record, indent=1))
        record["artifact"] = str(path)
    return record


def local_bytes(args, shardings, mesh) -> int:
    """The bytes of each rank's local shards of a tree of meta tensors
    placed by ``shardings`` (rank 0's, the largest, for an uneven split)."""
    total = 0

    def leaf(a, place):
        nonlocal total
        if isinstance(a, KVCache):
            leaf(a.k, place.k)
            leaf(a.v, place.v)
        elif isinstance(a, torch.Tensor):
            local = list(a.shape)
            for i, p in enumerate(place):
                if p.is_shard():
                    local[p.dim] = -(-local[p.dim] // mesh.size(i))
            total += int(torch.Size(local).numel()) * a.element_size()

    tree_map(leaf, args, shardings)
    return total


def cut_depths(cfg, remat_group: int = 1) -> tuple:
    """Two super-block counts (n1, n2 = n1 + remat_group) with the full
    depth's structure: the same remainder of super-blocks outside the remat
    groups, at least two super-blocks (the stacked layout)."""
    n_full = cfg.num_layers // cfg.pattern_period
    g = max(remat_group, 1)
    rem = n_full % g if g > 1 else 0
    n1 = rem
    while n1 < 2:
        n1 += g
    return n1, n1 + g


def _with_depth(cfg, n_super: int):
    period = cfg.pattern_period
    return dataclasses.replace(cfg, num_layers=n_super * period + cfg.num_layers % period)


def _affine(f1: float, f2: float, n1: int, n2: int, n: int) -> float:
    return f1 + (f2 - f1) * (n - n1) / (n2 - n1)


def estimate_cell(arch: str, cfg, shape: str, mesh, mesh_name: str, *, device: str = "cuda",
                  save: bool = True, art_dir: Path = ART_DIR) -> dict:
    """The cell's record from traces of the same step cut in depth (and, for
    a train cell, in microbatches), extended to the full cell.

    Every super-block (and every remat group) of a model does the same
    work, and so does every microbatch after the first, so each count is
    affine in the super-block count ``n`` at a fixed microbatch count, and
    in the microbatch count ``m`` at a fixed depth: bilinear in (n, m).
    Four traces, n in :func:`cut_depths` and m in (2, 3), fix it (two for
    a serving cell, which has no microbatches): this is the reference's loop
    correction (a scan body counted once, times its trip count).  The peak
    is affine in ``n`` and the same for every m >= 2 (the accumulators live
    from the second microbatch on), so it comes from the m = 2 pair.  The
    arguments' bytes are the full cell's, computed from its shardings.
    :func:`run_cell` traces the full cell instead."""
    from repro_torch.launch.steps import MICROBATCHES, REMAT_GROUP
    from repro_torch.zoo.configs.shapes import SHAPES

    if arch == "groot-gnn":
        return run_cell(build(arch, cfg, shape, mesh), mesh, mesh_name, save=save,
                        device=device, art_dir=art_dir)
    full = build_cell(cfg, shape, mesh)
    train = SHAPES[shape].kind == "train"
    rg = REMAT_GROUP.get(cfg.name, REMAT_GROUP["default"]) if train else 1
    n1, n2 = cut_depths(cfg, rg)
    n_full = cfg.num_layers // cfg.pattern_period
    ms = (2, 3) if train else (None,)
    m_full = MICROBATCHES.get(cfg.name, MICROBATCHES["default"]) if train else None
    t0 = time.perf_counter()
    recs = {}
    for n in (n1, n2):
        for m in ms:
            spec = None
            if train:  # m microbatches of the full cell's size
                spec = dataclasses.replace(SHAPES[shape],
                                           global_batch=SHAPES[shape].global_batch // m_full * m)
            cell = build_cell(_with_depth(cfg, n), shape, mesh, microbatches=m, spec=spec)
            recs[n, m] = run_cell(cell, mesh, mesh_name, save=False, device=device)

    def fit(get):
        at = {k: get(r) for k, r in recs.items()}
        if not train:
            return _affine(at[n1, None], at[n2, None], n1, n2, n_full)
        f2 = _affine(at[n1, 2], at[n2, 2], n1, n2, n_full)
        f3 = _affine(at[n1, 3], at[n2, 3], n1, n2, n_full)
        return f2 + (f3 - f2) * (m_full - 2)

    hlo = {k: fit(lambda r, k=k: r["hlo"][k]) for k in (
        "dot_flops_per_device", "collective_bytes_per_device", "traffic_bytes_per_device",
        "ops")}
    kinds = sorted({k for r in recs.values() for k in r["hlo"]["collective_by_kind"]})
    hlo["collective_by_kind"] = {k: fit(lambda r, k=k: r["hlo"]["collective_by_kind"].get(k, 0.0))
                                 for k in kinds}
    args_bytes = local_bytes(full.args, full.in_shardings, mesh)
    param_bytes = local_bytes(full.args[0], full.in_shardings[0], mesh)
    hlo["entry_param_bytes_per_device"] = float(args_bytes)
    m_peak = 2 if train else None
    peak = _affine(recs[n1, m_peak]["memory_analysis"]["peak_bytes"],
                   recs[n2, m_peak]["memory_analysis"]["peak_bytes"], n1, n2, n_full)
    record = {
        "arch": cfg.name, "shape": shape, "mesh": mesh_name, "devices": int(mesh.size()),
        "device_type": device, "meta": full.static_meta,
        "timing": {"trace_s": round(time.perf_counter() - t0, 2)},
        "memory_analysis": {"argument_size_in_bytes": args_bytes, "peak_bytes": int(peak)},
        "hlo": hlo,
        "k8_traced": int(round(fit(lambda r: r["k8_traced"]))),
        "param_bytes_per_device": param_bytes,
        "method": {"super_blocks": [n1, n2], "of": n_full,
                   "microbatches": list(ms) if train else None, "of_microbatches": m_full},
    }
    if save:
        out = Path(art_dir) / mesh_name
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{cfg.name}__{shape}.json"
        path.write_text(json.dumps(record, indent=1))
        record["artifact"] = str(path)
    return record


def iter_cells(arch_filter=None, shape_filter=None, smoke: bool = False):
    for arch in ARCHS:
        if arch_filter and arch != arch_filter:
            continue
        cfg = get_config(arch, smoke=smoke)
        shapes = list(GROOT_SHAPES) if arch == "groot-gnn" else supported_shapes(cfg)
        for shape in shapes:
            if shape_filter and shape != shape_filter:
                continue
            yield arch, cfg, shape


def build(arch: str, cfg, shape: str, mesh):
    return build_groot_cell(cfg, shape, mesh) if arch == "groot-gnn" else \
        build_cell(cfg, shape, mesh)


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry run")
    ap.add_argument("--arch", default=None, help="architecture id")
    ap.add_argument("--shape", default=None, help="input-shape name")
    ap.add_argument("--mesh", default="both", choices=("pod", "multipod", "both"))
    ap.add_argument("--all", action="store_true", help="every cell")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the program traced: the card's (fake CUDA tensors) or the CPU's")
    ap.add_argument("--out", default=str(ART_DIR), help="artifact directory")
    ap.add_argument("--exact", action="store_true",
                    help="trace each cell whole instead of cut in depth and extended")
    args = ap.parse_args(argv)
    if args.arch in PORT_ARCHS:
        raise SystemExit(f"{args.arch}: a port-only arch whose dropless experts have no "
                         "expert-parallel form; the dry run traces sharded cells only")

    if args.list:
        for arch, _, shape in iter_cells():
            print(f"{arch:28s} {shape}")
        return

    t0 = time.perf_counter()
    torch.set_num_threads(1)
    meshes = [m for m in MESH_NAMES if args.mesh in (m, "both")]
    failures = []
    for mesh_name in meshes:
        with fake_world(world_size(mesh_name)):
            mesh = make_production_mesh(multi_pod=MESH_NAMES[mesh_name],
                                        device_type=args.device)
            for arch, cfg, shape in iter_cells(args.arch, args.shape):
                tag = f"{arch} x {shape} x {mesh_name}"
                try:
                    if args.exact:
                        rec = run_cell(build(arch, cfg, shape, mesh), mesh, mesh_name,
                                       device=args.device, art_dir=Path(args.out))
                    else:
                        rec = estimate_cell(arch, cfg, shape, mesh, mesh_name,
                                            device=args.device, art_dir=Path(args.out))
                    h, m = rec["hlo"], rec["memory_analysis"]
                    print(
                        f"[ok] {tag:64s} trace={rec['timing']['trace_s']:7.1f}s "
                        f"args/dev={m['argument_size_in_bytes'] / 1e9:7.2f} GB "
                        f"peak/dev={m['peak_bytes'] / 1e9:7.2f} GB "
                        f"dotTF/dev={h['dot_flops_per_device'] / 1e12:9.3f} "
                        f"collGB/dev={h['collective_bytes_per_device'] / 1e9:8.3f} "
                        f"k8={rec['k8_traced']}",
                        flush=True,
                    )
                except Exception as e:  # noqa: BLE001
                    failures.append((tag, repr(e)))
                    print(f"[FAIL] {tag}: {e}", flush=True)
                    traceback.print_exc()

    wall = time.perf_counter() - t0
    if failures:
        print(f"\n{len(failures)} FAILURES in {wall:.1f} s:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print(f"\nall dry-run cells traced in {wall:.1f} s.")


if __name__ == "__main__":
    main()
