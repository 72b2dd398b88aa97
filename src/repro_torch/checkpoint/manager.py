"""Crash-safe per-partition prediction journal for streamed runs (port of
``repro/checkpoint/manager.py:PartitionJournal``, host numpy).

The file layout, the atomic commit and the plan fingerprint are the
reference's, so a journal either package wrote restores in the other.  The
reference module's step checkpoints (``save``, ``restore``,
``latest_step``, ``CheckpointManager``) serve the zoo's training loop and
are not ported (ROADMAP Queue 1, item 8).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path

import numpy as np

from repro_torch import faults


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
