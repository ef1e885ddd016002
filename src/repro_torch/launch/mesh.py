"""Mesh construction (a port of ``repro.launch.mesh``).

The port runs on one card: a mesh is a record of its axis names and a
``devices`` array of one ``torch.device``, which is all the sharding rules
(``train.sharding``) and the dry run (``launch.dryrun``; ``--local`` is
``make_local_mesh("meta")``) read.  A shape of more than one device raises
``NotImplementedError`` (``train.sharding.NOT_PORTED``), and so does the
production mesh, until the specs are applied across cards.  A mesh's axis
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
from repro_torch.train.sharding import NOT_PORTED


@dataclass(frozen=True)
class Mesh:
    """Axis names and an object array of devices shaped as the mesh."""
    axis_names: tuple
    devices: np.ndarray


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's (16, 16) or (2, 16, 16) mesh: more than one device,
    so it raises ``NotImplementedError``."""
    raise NotImplementedError(NOT_PORTED)


def make_mesh(shape: tuple, axes: tuple, device="cuda") -> Mesh:
    """A mesh of ``shape`` over ``axes`` on ``device`` (the card unless the
    caller asks for the CPU); every dim must be 1."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if math.prod(shape) != 1:
        raise NotImplementedError(NOT_PORTED)
    devices = np.empty(tuple(shape), dtype=object)
    devices.flat[0] = resolve_device(device)
    return Mesh(tuple(axes), devices)


def make_local_mesh(device="cuda") -> Mesh:
    """Single-device mesh for smoke tests (axes present, size 1)."""
    return make_mesh((1, 1), ("data", "model"), device)
