"""Activation sharding hooks (a port of the part of ``repro.train.sharding``
that ``models.lm`` reaches: ``set_activation_axes`` and ``constrain``).

The port runs on one card.  There, as in the reference on one device, no
activation axis is set and ``constrain`` returns its input.  A mesh of more
than one device is refused: the parameter and activation shardings
(``gather_weight``, the parameter rules, ``make_*_shardings``) come with
the training half of the LM stack, and an activation that silently stayed
replicated across devices would be a different program.
"""
from __future__ import annotations

NOT_PORTED = ("sharding over more than one device is not ported yet: it comes with "
              "the training half of the LM stack (ROADMAP queue 1 item 7)")


def _mesh_size(mesh) -> int:
    """Devices of ``mesh``: torch's ``DeviceMesh`` (its ``.mesh`` tensor of
    ranks) or anything with a ``.devices`` array, as a JAX mesh has."""
    devices = mesh.mesh if hasattr(mesh, "mesh") else mesh.devices
    n = 1
    for d in devices.shape:
        n *= int(d)
    return n


def set_activation_axes(mesh) -> None:
    """Configure the logical activation axes for ``constrain``.  ``None`` or
    a one-device mesh sets none (``constrain`` stays the identity); a larger
    mesh raises ``NotImplementedError``."""
    if mesh is not None and _mesh_size(mesh) > 1:
        raise NotImplementedError(NOT_PORTED)


def constrain(x, tags):
    """The reference's ``with_sharding_constraint`` with logical tags ('dp',
    'tp', None) per dim.  No axis is ever set on one card, so it returns
    ``x`` itself, as the reference does with none set."""
    return x
