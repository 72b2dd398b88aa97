"""The device side of sharded streaming: one wave = one launch per lane
(port of ``repro/mesh/runner.py``).

:class:`MeshRunner` executes :class:`~repro_torch.mesh.plan.Wave`\\ s over
lanes.  Lane ``d`` owns ``devices[d]`` and holds, on it:

  * its own copy of the params (copied once; the caller's model is never
    moved),
  * its own CUDA stream (on a CUDA device),
  * its own :class:`~repro_torch.service.scheduler.BucketRunner` (one
    padded forward per packed batch, one packed structure's device copies
    held at a time),
  * its own worker thread, which enters the lane's device and stream
    before every launch: the hand-written kernels launch on the calling
    thread's current device and stream.

PyTorch has no ``pmap``, so the reference's two paths (one SPMD program on
"ref"/"onehot", a per-lane jit on the ``groot*`` backends) are both per-lane
launches here.  :meth:`MeshRunner.launch_wave` hands every active lane to
its worker before it waits on any of them — the reference's "dispatch every
lane before blocking on any readback" — and each worker reads its own
predictions back.  The split survives in the compile probe:
``compile_count`` counts first sights across all lanes together (packed
signatures on the shape-stable backends, packed structures on the
structure-keyed ones), which is what the reference traces: its pmap once
for all lanes, its jit once per structure whichever lane meets it.

Partitions never cross lanes (GROOT Alg. 1 independence), so lanes exchange
nothing: there is no collective.

``devices=`` names the lanes explicitly and may repeat a device (two lanes
on one card: two streams, two params copies, two runners).  It is the
port's counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count``, which has no PyTorch
equivalent.
"""
from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.core import gnn
from repro_torch.kernels.plan_cache import structure_keys
from repro_torch.launch import mesh as host_mesh
from repro_torch.launch.mesh import HostMesh, MeshConfigError
from repro_torch.obs import REGISTRY
from repro_torch.service.scheduler import (
    SHAPE_STABLE_BACKENDS,
    STRUCTURE_KEYED_BACKENDS,
    BucketRunner,
)


class _Lane:
    """One lane: a device, a params copy, a stream, a runner, a worker."""

    def __init__(self, index: int, params, backend: str, device: torch.device,
                 stream_dtype: Optional[str]):
        self.device = device
        self.params = gnn.as_model(params, device)
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.runner = BucketRunner(self.params, backend, stream_dtype=stream_dtype,
                                   device=device)
        self.worker = ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix=f"mesh-lane-{index}")

    def context(self):
        """The lane's device and stream as the current ones."""
        if self.stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack


class MeshRunner:
    """Replicated-params wave launcher over ``num_devices`` mesh lanes."""

    def __init__(self, params, backend: str = "ref", *,
                 num_devices: Optional[int] = None, devices: Optional[list] = None,
                 device=None, stream_dtype: Optional[str] = None):
        """``params``: anything :func:`repro_torch.core.gnn.as_model` takes.
        ``num_devices``: the first N of ``visible_devices(device)`` (all of
        them when None; past them :class:`MeshConfigError`).  ``devices``:
        an explicit lane list instead, repeats allowed."""
        if backend not in SHAPE_STABLE_BACKENDS + STRUCTURE_KEYED_BACKENDS:
            raise ValueError(
                f"mesh backend must be one of {SHAPE_STABLE_BACKENDS} or "
                f"{STRUCTURE_KEYED_BACKENDS}, got {backend!r}"
            )
        if devices is None:
            # through the module: a test may stand in for the visible devices
            visible = len(host_mesh.visible_devices(device))
            if num_devices is None:
                num_devices = visible
            if num_devices < 1 or num_devices > visible:
                raise MeshConfigError(
                    f"mesh_devices={num_devices} out of range: "
                    f"{visible} device(s) visible"
                )
            #: the data axis of the host mesh — lane d owns devices[d]
            self.mesh = host_mesh.make_host_mesh(data=num_devices, device=device)
        else:
            devices = [torch.device(d) for d in devices]
            if not devices or num_devices not in (None, len(devices)):
                raise MeshConfigError(
                    f"mesh_devices={num_devices} does not match the {len(devices)} "
                    f"lane device(s) given"
                )
            grid = np.empty((len(devices), 1), dtype=object)
            grid[:, 0] = devices
            self.mesh = HostMesh(grid)
        self.devices = list(self.mesh.devices.ravel())
        self.num_devices = len(self.devices)
        self.backend = backend
        self.compile_count = 0
        self.run_count = 0          # wave launches
        self.lane_run_count = 0     # per-lane launches (<= waves * devices)
        self._lock = threading.Lock()         # one wave at a time
        self._seen_lock = threading.Lock()    # the lanes' shared compile probe
        self._seen: set = set()
        self._lanes = [_Lane(d, params, backend, dev, stream_dtype)
                       for d, dev in enumerate(self.devices)]
        for dev in {dev for dev in self.devices if dev.type == "cuda"}:
            torch.cuda.synchronize(dev)   # the params copies, before any lane stream

    @property
    def structure_keyed(self) -> bool:
        return self.backend in STRUCTURE_KEYED_BACKENDS

    def launch_wave(self, batches: list, gkeys: Optional[list] = None) -> list:
        """Run one wave: ``batches[d]`` is lane *d*'s packed-array dict or
        None for an idle lane; ``gkeys[d]`` its ``structure_keys`` where
        the caller hashed it.  Returns per-lane ``np.ndarray`` predictions
        (None where the lane idled).  A lane's failure is raised once every
        lane of the wave has finished."""
        assert len(batches) == self.num_devices
        active = [d for d, b in enumerate(batches) if b is not None]
        if not active:
            return [None] * self.num_devices
        if gkeys is None:
            gkeys = [None] * self.num_devices
        with self._lock:
            self.run_count += 1
            self.lane_run_count += len(active)
            futures = {d: self._lanes[d].worker.submit(self._run_lane, d, batches[d], gkeys[d])
                       for d in active}
            preds: list = [None] * self.num_devices
            error = None
            for d in active:
                try:
                    preds[d] = futures[d].result()
                except BaseException as e:  # noqa: BLE001 — raised after the wave
                    error = error or e
            if error is not None:
                raise error
            return preds

    def _run_lane(self, d: int, batch: dict, gkeys) -> np.ndarray:
        lane = self._lanes[d]
        with lane.context():
            if self.structure_keyed:
                if gkeys is None:
                    gkeys = structure_keys(batch["edge_src"], batch["edge_dst"],
                                           batch["num_nodes"])
                self._first_sight(gkeys)
            else:
                self._first_sight((batch["x"].shape, batch["edge_src"].shape,
                                   batch["num_nodes"]))
            return lane.runner(batch, gkeys)

    def _first_sight(self, key) -> None:
        with self._seen_lock:
            if key in self._seen:
                return
            self._seen.add(key)
            self.compile_count += 1
        REGISTRY.counter("mesh.runner_compiles").inc()

    def release(self) -> None:
        """Drop every lane's held packed structure (its device copies)."""
        for lane in self._lanes:
            lane.runner.release()

    def close(self) -> None:
        """Stop the lane workers and drop everything the lanes hold on their
        devices but the params copies: the held structures, and the cuBLAS
        workspaces the lane streams took from the caching allocator."""
        for lane in self._lanes:
            lane.worker.shutdown(wait=True)
        self.release()
        if any(dev.type == "cuda" for dev in self.devices):
            clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
            if clear is not None:
                clear()
