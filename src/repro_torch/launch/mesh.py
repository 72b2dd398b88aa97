"""Host device meshes (port of ``repro/launch/mesh.py``).

A function (not a module-level constant) so importing never touches device
state.  :func:`visible_devices` is the port's counterpart of
``jax.devices()``: every CUDA device on ``cuda``, the one host device on
``cpu``.  :func:`make_host_mesh` lays the first ``data * model`` of them out
as a ``(data, model)`` grid, which :class:`repro_torch.mesh.MeshRunner`
reads lane by lane along the data axis.

The reference's ``make_production_mesh`` (a 256-chip TPU pod for the zoo's
dry run) is not ported here: it belongs to the zoo's tooling (ROADMAP
Queue 1, item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device


class MeshConfigError(ValueError):
    """The requested mesh shape cannot be built from the visible devices."""


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
