"""Mesh construction (a port of ``repro.launch.mesh``).

A mesh of one device is a record of its axis names and a ``devices`` array
of one ``torch.device`` (``Mesh``): the sharding rules (``train.sharding``)
and the dry run (``launch.dryrun``; ``--local`` is
``make_local_mesh("meta")``) read it, and nothing is placed on it, so a
one-device run keeps plain tensors.  A shape of more than one device is a
``torch.distributed`` ``DeviceMesh`` (``init_device_mesh``) over the process
group this process belongs to, whose world size must equal the mesh's
devices; the production meshes are built the same way (on the CPU under a
``fake`` group of 256 or 512 ranks, which runs nothing).  A mesh's axis
sizes alone, which is all the dry run's analytic half reads
(``launch.calibrate.analytic_bytes``, ``launch.dryrun.train_microbatches``),
need no devices: any record with ``axis_names`` and a ``devices`` array of
the mesh's shape serves.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.kernels import resolve_device


@dataclass(frozen=True)
class Mesh:
    """Axis names and an object array of devices shaped as the mesh."""
    axis_names: tuple
    devices: np.ndarray


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's (16, 16) ('data', 'model') or (2, 16, 16) ('pod',
    'data', 'model') mesh, a ``DeviceMesh`` over a process group of 256 or
    512 ranks (``make_mesh``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_mesh(shape: tuple, axes: tuple, device="cuda"):
    """A mesh of ``shape`` over ``axes`` on ``device`` (the card unless the
    caller asks for the CPU).  One device gives a ``Mesh`` record; more give
    ``init_device_mesh(device type, shape, mesh_dim_names=axes)``, which
    needs an initialised process group of exactly that many ranks, else
    ``RuntimeError`` naming both numbers (it never falls back to one
    device)."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    n = math.prod(shape)
    if n == 1:
        devices = np.empty(tuple(shape), dtype=object)
        devices.flat[0] = resolve_device(device)
        return Mesh(tuple(axes), devices)
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else None
    if world != n:
        have = (f"a process group of {world} ranks" if world is not None
                else "no initialised process group")
        raise RuntimeError(f"a mesh of shape {tuple(shape)} needs a process group of {n} "
                           f"ranks; this process has {have}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_local_mesh(device="cuda") -> Mesh:
    """Single-device mesh for smoke tests (axes present, size 1)."""
    return make_mesh((1, 1), ("data", "model"), device)
