"""Elastic scaling: rebuild the mesh after topology changes (port of
``repro/distributed/elastic.py``).

A pod loss (512 -> 256 GPUs) or expansion changes the device set; the
parameters' logical axes are topology-independent, so re-deployment is:

    new_mesh   = choose_mesh(len(healthy_ranks))
    shardings  = tree_shardings(spec_tree, new_mesh, make_rules(new_mesh))
    state      = restore(like, ckpt_dir) placed by those shardings

``choose_mesh`` picks the largest (data x model) grid with the preferred
TP width that fits the device count; global batch is re-split over the
new data extent (batch scaling policy: keep global batch, grow per-device
batch — the optimizer schedule is unchanged).
"""
from __future__ import annotations

import numpy as np


def mesh_shape(n_devices: int, *, prefer_model: int = 16) -> tuple:
    """(data, model): the largest grid over ``n_devices`` with TP <=
    ``prefer_model`` (halved until it divides the device count)."""
    model = min(prefer_model, n_devices)
    while n_devices % model:
        model //= 2
    return n_devices // model, model


def choose_mesh(n_devices: int, *, prefer_model: int = 16, device_type: str = "cuda"):
    """The (data, model) mesh over ``n_devices``: a ``DeviceMesh`` over the
    first ``n_devices`` ranks of the initialised process group, or, with
    none, a host mesh over the visible devices
    (``launch/mesh.py:HostMesh``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import HostMesh, MeshConfigError, visible_devices

    data, model = mesh_shape(n_devices, prefer_model=prefer_model)
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if world < n_devices:
            raise MeshConfigError(f"{n_devices} ranks asked for, the process group has {world}")
        from torch.distributed.device_mesh import DeviceMesh

        return DeviceMesh(device_type, torch.arange(n_devices).reshape(data, model),
                          mesh_dim_names=("data", "model"))
    devices = visible_devices(device_type)
    if len(devices) < n_devices:
        raise MeshConfigError(f"{n_devices} devices asked for, {len(devices)} visible")
    grid = np.empty((data, model), dtype=object)
    for i, dev in enumerate(devices[:n_devices]):
        grid[i // model, i % model] = dev
    return HostMesh(grid)


def replan_batch(global_batch: int, old_data: int, new_data: int) -> dict:
    """Keep the global batch constant across topology changes."""
    assert global_batch % new_data == 0, (
        f"global batch {global_batch} not divisible by data={new_data}"
    )
    return {
        "global_batch": global_batch,
        "per_device_batch_old": global_batch // old_data,
        "per_device_batch_new": global_batch // new_data,
    }
