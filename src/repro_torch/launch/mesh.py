"""Host device meshes (port of ``repro/launch/mesh.py``).

A function (not a module-level constant) so importing never touches device
state.  :func:`visible_devices` is the port's counterpart of
``jax.devices()``: every CUDA device on ``cuda``, the one host device on
``cpu``.  :func:`make_host_mesh` lays the first ``data * model`` of them out
as a ``(data, model)`` grid, which :class:`repro_torch.mesh.MeshRunner`
reads lane by lane along the data axis.

:func:`make_production_mesh` is the zoo's production mesh, a
``torch.distributed`` ``DeviceMesh`` of the reference's shape and axis
names: ``(16, 16)`` ``("data", "model")`` over 256 ranks, or ``(2, 16, 16)``
``("pod", "data", "model")`` over 512.  It needs a process group of that
world size: a real one (``torchrun`` on 256 or 512 GPUs) or the fake
backend the dry run opens for itself (``launch/dryrun.py:fake_world``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device


class MeshConfigError(ValueError):
    """The requested mesh shape cannot be built from the visible devices."""


PRODUCTION_MESHES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production ``DeviceMesh``: 256 ranks as ``(data 16, model 16)``,
    or 512 as ``(pod 2, data 16, model 16)`` with ``multi_pod``.  Raises
    :class:`MeshConfigError` naming the world size it needs when no process
    group of that size is initialised."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = PRODUCTION_MESHES[bool(multi_pod)]
    need = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0
    if have != need:
        raise MeshConfigError(
            f"the {'multi-pod' if multi_pod else 'pod'} mesh {shape} {names} needs a process "
            f"group of {need} ranks (torchrun, or the dry run's fake backend); "
            + (f"the initialised one has {have}" if have else "none is initialised"))
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def visible_devices(device=None) -> list:
    """The devices of ``device``'s type a mesh may use: ``cuda:0`` ..
    ``cuda:<n-1>`` on ``cuda`` (the default), ``[cpu]`` on ``cpu``."""
    device = resolve_device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(device.type)]


@dataclasses.dataclass(frozen=True, eq=False)
class HostMesh:
    """A ``(data, model)`` grid of devices (``jax.sharding.Mesh``'s shape)."""

    devices: np.ndarray                 # (data, model) object array of torch.device
    axis_names: tuple = ("data", "model")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def make_host_mesh(model: int = 1, *, data: Optional[int] = None, device=None) -> HostMesh:
    """Small mesh over whatever devices exist (tests / examples).

    ``data`` caps the data axis to fewer shards than the visible devices
    allow — a test on an 8-device host can ask for a 2-way mesh.
    """
    devices = visible_devices(device)
    n = len(devices)
    if model < 1 or n % model:
        raise MeshConfigError(
            f"model axis {model} does not divide the {n} visible devices"
        )
    max_data = n // model
    if data is None:
        data = max_data
    if data < 1 or data > max_data:
        raise MeshConfigError(
            f"data axis {data} out of range: {n} devices / model={model} "
            f"admit at most {max_data} data shards"
        )
    grid = np.empty((data, model), dtype=object)
    for i, dev in enumerate(devices[: data * model]):
        grid[i // model, i % model] = dev
    return HostMesh(grid)
