"""Fault-tolerant checkpointing (port of ``repro/checkpoint/manager.py``):
the zoo's step checkpoints (``save``, ``latest_step``, ``restore``,
``CheckpointManager``) and the streamed route's per-partition journal
(``PartitionJournal``), host numpy.

Step checkpoints, one directory per step, the reference's format:

    <dir>/step_000000120.tmp/        written first
        shard_<host>.npz             leaves as ``leaf_%05d`` arrays
        manifest.json                step, leaf names, shapes and dtypes
    <dir>/step_000000120/            atomic rename when complete

A tree's leaves are taken in the reference's flatten order (dict keys
sorted; lists, tuples and ``NamedTuple``s in order; ``None`` empty), so the
port's training state ``(params, AdamWState(step, m, v))`` (Q8 moments as
``(q, scale)``) writes the reference's leaves in the reference's order, and
each package restores the other's checkpoints.  Leaf names follow JAX's
``keystr`` (``['blocks'][0]['attn']['wq']``, ``.step``); the port's
optimizer state holds lists where the reference holds trees, so the names of
its moments read ``[1].m[5]`` where the reference's read
``[1].m['blocks'][0]['attn']['wq']``: only the keys are read back.  A bf16
tensor has no numpy dtype (there is no ``ml_dtypes`` on the card's
machine), so :func:`save` refuses one with a ``ValueError``; the training
state holds none.  ``restore`` takes a ``device`` where the reference takes
``shardings``.  A tree of DTensors (the sharded launcher's state) is saved
and restored by all ranks together, rank 0 alone writing and reading its
leaves, one leaf at a time: the checkpoint is the one a single device would
write (:func:`save`, :func:`restore`).

The journal's file layout, the atomic commit and the plan fingerprint are
the reference's, so a journal either package wrote restores in the other.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import threading
import time
import zipfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch import faults
from repro_torch.zoo.configs.base import leaves, tree_map, unflatten


# ---------------------------------------------------------------------------
# Step checkpoints
# ---------------------------------------------------------------------------

def _flatten_with_names(tree, prefix: str = "") -> list:
    """(name, leaf) pairs in :func:`leaves` order, named as JAX's keystr."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten_with_names(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f, t in zip(tree._fields, tree)
                for x in _flatten_with_names(t, f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree) for x in _flatten_with_names(t, f"{prefix}[{i}]")]
    return [] if tree is None else [(prefix, tree)]


def _rank() -> int:
    """This process's rank in the default process group (0 without one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _is_sharded(tree) -> bool:
    from repro_torch.sharding.rules import is_dtensor

    return any(is_dtensor(x) for x in leaves(tree))


def _host_copy(leaf) -> np.ndarray:
    """A leaf as a numpy array of its own (tensors copied off the device)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise ValueError("a bfloat16 leaf has no numpy dtype; cast it to float32 before "
                             "saving (the training state holds f32 masters)")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def save(tree, directory: str | os.PathLike, step: int, *, host_id: int = 0) -> Path:
    """Synchronous atomic save of a tree of tensors or arrays, written to
    the file one leaf at a time.

    A tree holding DTensors is saved by every rank of the default process
    group together: each DTensor leaf in turn is gathered whole (a
    collective, so every rank calls ``save`` at the same point), rank 0
    alone copies it to the host and writes it, and the other ranks drop
    it.  The checkpoint is the one a single device would write, and no
    process holds more than one whole leaf.  Every rank returns once rank 0
    has published it (a barrier); ``directory`` is rank 0's."""
    from repro_torch.sharding.rules import is_dtensor

    sharded = _is_sharded(tree)
    writer = not sharded or _rank() == 0
    d = Path(directory)
    final = d / f"step_{step:09d}"
    tmp = d / (final.name + ".tmp")
    manifest = {"step": step, "leaves": [], "hosts": 1}
    if writer:
        tmp.mkdir(parents=True, exist_ok=True)
    # the layout np.savez writes (one stored ``<key>.npy`` member a leaf)
    with (zipfile.ZipFile(tmp / f"shard_{host_id}.npz", "w", allowZip64=True) if writer
          else contextlib.nullcontext()) as zf:
        for i, (name, leaf) in enumerate(_flatten_with_names(tree)):
            if is_dtensor(leaf):
                leaf = leaf.full_tensor()
            if writer:
                arr = leaf if isinstance(leaf, np.ndarray) else _host_copy(leaf)
                key = f"leaf_{i:05d}"
                with zf.open(key + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
                manifest["leaves"].append({"key": key, "name": name, "shape": list(arr.shape),
                                           "dtype": str(arr.dtype)})
                del arr
            del leaf
    if writer:
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
    if sharded:
        import torch.distributed as dist

        dist.barrier()
    return final


def latest_step(directory: str | os.PathLike) -> Optional[int]:
    d = Path(directory)
    if not d.exists():
        return None
    steps = []
    for p in d.iterdir():
        if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp"):
            if (p / "manifest.json").exists():
                steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def restore(like_tree, directory: str | os.PathLike, *, step: Optional[int] = None,
            device=None):
    """Load a checkpoint into the structure of ``like_tree``.  Returns
    (tree, step).  A tensor leaf comes back as a tensor of the like leaf's
    dtype on ``device`` (default: the like leaf's), requiring grad where the
    like leaf does (an ``nn.Parameter`` as an ``nn.Parameter``); an array
    leaf as an array of its dtype.

    A DTensor leaf comes back as a DTensor of the like leaf's placements:
    every rank of the default process group restores together, rank 0
    reads the leaf and broadcasts it, and each rank keeps its own shard, so
    one process reads each DTensor leaf and none holds more than one whole.
    Every rank reads the manifest and the other leaves, so ``directory``
    must be one that every rank sees."""
    from repro_torch.sharding.rules import is_dtensor

    d = Path(directory)
    step = step if step is not None else latest_step(d)
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {d}")
    final = d / f"step_{step:09d}"
    manifest = json.loads((final / "manifest.json").read_text())
    flat_like = leaves(like_tree)
    if len(flat_like) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, target tree "
                         f"{len(flat_like)}")
    root = _rank() == 0
    out = []
    with np.load(final / "shard_0.npz") as data:  # members are read on access
        for like, entry in zip(flat_like, manifest["leaves"]):
            if not isinstance(like, torch.Tensor):
                arr = data[entry["key"]]
                out.append(arr.astype(like.dtype) if hasattr(like, "dtype") else arr)
                continue
            dev = like.device if device is None else device
            if is_dtensor(like):
                t = _from_root(data[entry["key"]] if root else None, like, dev)
            else:
                t = torch.from_numpy(np.array(data[entry["key"]])).to(device=dev,
                                                                      dtype=like.dtype)
            if isinstance(like, torch.nn.Parameter):
                t = torch.nn.Parameter(t, requires_grad=like.requires_grad)
            elif like.requires_grad:
                t.requires_grad_(True)
            out.append(t)
    return unflatten(like_tree, out), step


def _from_root(arr: Optional[np.ndarray], like, dev):
    """Rank 0's whole ``arr`` broadcast to every rank and placed as the
    DTensor ``like`` (each rank keeps its own shard of its copy)."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    if arr is None:
        t = torch.empty(tuple(like.shape), dtype=like.dtype, device=dev)
    else:
        t = torch.from_numpy(np.array(arr)).to(device=dev, dtype=like.dtype)
    dist.broadcast(t, src=0)
    return distribute_tensor(t, like.device_mesh, like.placements, src_data_rank=None)


class CheckpointManager:
    """Async manager: ``save_async`` snapshots to host memory and writes on
    a background thread; keeps the newest ``keep`` checkpoints.  ``wait()``
    joins the write in flight and re-raises its error."""

    def __init__(self, directory: str | os.PathLike, *, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.save_count = 0
        self.last_error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def save_async(self, tree, step: int):
        self.wait()
        if _is_sharded(tree):
            # DTensor leaves are gathered by collectives, which must keep
            # their order among the step's own: saved now, on this thread
            save(tree, self.directory, step)
            if _rank() == 0:
                self._gc()
            self.save_count += 1
            return
        # snapshot to host memory now: the caller updates its tensors in place
        host_tree = tree_map(lambda x: None if x is None else _host_copy(x), tree)

        def work():
            try:
                save(host_tree, self.directory, step)
                self._gc()
                self.save_count += 1
            except Exception as e:  # noqa: BLE001 - re-raised by wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(p for p in self.directory.iterdir()
                       if p.is_dir() and p.name.startswith("step_"))
        complete = [p for p in steps if not p.name.endswith(".tmp")]
        for p in complete[: -self.keep]:
            shutil.rmtree(p, ignore_errors=True)
        # orphaned tmp dirs from crashes
        for p in steps:
            if p.name.endswith(".tmp") and time.time() - p.stat().st_mtime > 300:
                shutil.rmtree(p, ignore_errors=True)


# ---------------------------------------------------------------------------
# Partition journal
# ---------------------------------------------------------------------------

class PartitionJournal:
    """Crash-safe per-partition prediction journal for streamed runs.

    A streamed verification of a huge design launches many packed batches;
    a crash (preemption, OOM kill) at batch *i* would forfeit batches
    ``0..i-1``.  The journal makes partition results durable as they land:

        <base>/<design_key>/
            meta.json            plan fingerprint + partition count
            part_00042.npz       ids (int64 core node ids), pred (int32)
            part_00042.npz.tmp   crashed mid-write -> ignored, overwritten

    A partition file either exists complete (tmp + ``os.replace``) or not at
    all.  Each file stores BOTH the core node ids and their predictions, so
    a restore scatters ``out[ids] = pred`` without consulting the plan — but
    the journal is only trusted when the plan *fingerprint* (a hash over
    every partition's core id layout plus the planning knobs) matches;
    different partitioning knobs wipe the directory and start fresh rather
    than scattering stale rows.
    """

    def __init__(self, base_dir: str | os.PathLike, design_key: str):
        self.dir = Path(base_dir) / design_key
        self._validated = False

    # -- plan identity -------------------------------------------------------

    @staticmethod
    def plan_fingerprint(plan) -> str:
        h = hashlib.sha256()
        h.update(
            repr((plan.num_nodes, plan.num_parts, plan.k, plan.regrow,
                  plan.partitioner, plan.seed)).encode()
        )
        for sg in plan.subgraphs:
            h.update(np.int64(sg.num_core).tobytes())
            h.update(np.ascontiguousarray(
                sg.global_ids[: sg.num_core], dtype=np.int64
            ).tobytes())
        return h.hexdigest()

    # -- lifecycle -----------------------------------------------------------

    def _part_path(self, index: int) -> Path:
        return self.dir / f"part_{index:05d}.npz"

    def open(self, plan) -> set:
        """Validate the journal directory against ``plan``; wipe it on a
        fingerprint mismatch.  Returns committed partition indices."""
        fp = self.plan_fingerprint(plan)
        meta_path = self.dir / "meta.json"
        meta = None
        if meta_path.exists():
            try:
                meta = json.loads(meta_path.read_text())
            except (OSError, ValueError):
                meta = None
        if meta is None or meta.get("plan") != fp:
            if self.dir.exists():
                shutil.rmtree(self.dir, ignore_errors=True)
            self.dir.mkdir(parents=True, exist_ok=True)
            tmp = meta_path.with_suffix(".json.tmp")
            tmp.write_text(json.dumps({"plan": fp, "num_parts": plan.num_parts}))
            os.replace(tmp, meta_path)
        self._validated = True
        done = set()
        for p in self.dir.glob("part_*.npz"):
            try:
                done.add(int(p.stem.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return done

    def restore(self, plan, out: np.ndarray) -> set:
        """Scatter every committed partition's core predictions into
        ``out``; returns the set of restored partition indices."""
        faults.fire("cache.load", tag=lambda: self.dir.name)
        restored = set()
        for i in sorted(self.open(plan)):
            if i >= plan.num_parts:
                continue
            try:
                with np.load(self._part_path(i)) as z:
                    ids, pred = z["ids"], z["pred"]
            except (OSError, ValueError, KeyError):
                # unreadable entry: drop it, the partition just re-runs
                self._part_path(i).unlink(missing_ok=True)
                continue
            if ids.shape != pred.shape or (
                ids.size and (ids.min() < 0 or ids.max() >= out.shape[0])
            ):
                self._part_path(i).unlink(missing_ok=True)
                continue
            out[ids] = pred
            restored.add(i)
        return restored

    def commit(self, index: int, ids: np.ndarray, pred: np.ndarray) -> None:
        """Atomically persist one partition's core predictions."""
        assert self._validated, "open()/restore() the journal before commit()"
        final = self._part_path(index)
        tmp = final.with_suffix(".npz.tmp")
        # savez appends ``.npz`` to bare names — write through an open file
        # handle so the tmp path is exactly what os.replace expects
        with open(tmp, "wb") as f:
            np.savez(
                f,
                ids=np.ascontiguousarray(ids, dtype=np.int64),
                pred=np.ascontiguousarray(pred, dtype=np.int32),
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)

    def complete(self) -> None:
        """The run finished: the verdict is computed upstream, so the
        journal has served its purpose — reclaim the space."""
        shutil.rmtree(self.dir, ignore_errors=True)
        self._validated = False
