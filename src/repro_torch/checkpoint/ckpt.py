"""Sharded checkpointing with manifests, async writes and auto-resume (a port
of ``repro.checkpoint.ckpt``, in its on-disk format, so that each package
restores the other's checkpoints).

Layout (one directory per step):
    ckpt_dir/step_000123/shard_<host>.npz    — leaf_<i>: this host's leaves
    ckpt_dir/step_000123/manifest.json       — step, paths, shapes, dtypes
    ckpt_dir/step_000123/COMMIT              — written last; absence = partial

Leaves are numbered in JAX's flattening order (``repro_torch.tree``: dict
keys sorted, NamedTuple fields in order, ``None`` dropped) and named by
their paths (``params/layers/attn/wq``, ``opt/m/...``).  bf16 is stored as
its ``uint16`` bits with ``"bfloat16"`` in the manifest, and read back
through torch's int16 view, so nothing here needs ``ml_dtypes``.

The reference's async save may read its arrays after it returns, because
JAX arrays are immutable; the port's parameters and moments are written in
place by the next step.  So ``save`` copies every leaf to the host before
it returns, and only the file writing goes to the thread.

A state placed across devices (DTensors, ``train.sharding.place``) is saved
as full leaves, and only rank 0 of the process group writes them: the
files are the one-device ones, and a blocking save returns on every rank
once they are committed.  The ranks gather one leaf at a time, each
joining the collective; only rank 0 copies it to the host, the others drop
it.  ``restore`` places what it
reads on the current mesh (the reference's "resharding happens on load"):
by ``shardings`` (a tree of specs, with ``mesh``), or like the ``like``
leaf it replaces where that is a DTensor.  A checkpoint saved on one mesh
thus restores on another, or on one device.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from repro_torch.convert import numpy_copy
from repro_torch.train import sharding
from repro_torch.tree import flatten_with_path, path_str, unflatten


def _snapshot(x) -> tuple:
    """(a host copy of ``x`` that numpy can save, its dtype's name as the
    manifest writes it); a DTensor is gathered first."""
    t = sharding.full(x) if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    a = numpy_copy(t)
    return a, "bfloat16" if t.dtype == torch.bfloat16 else str(a.dtype)


def _group_rank():
    """This process's rank in the initialised process group, else None."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else None


def save(ckpt_dir: str, step: int, state, host: int = 0, blocking: bool = True):
    """Save a tree ``state`` (tensors on any device, DTensors, or what
    ``torch.as_tensor`` takes).  Returns None, or with ``blocking=False``
    the writing thread (join() it); either way every leaf was copied to the
    host before it returns.  A placed state is saved by every rank of the
    group together, one leaf gathered at a time; rank 0 copies and writes
    them, and the other ranks drop what they gathered and return None, at
    once or with ``blocking`` once rank 0's files are committed."""
    flat = flatten_with_path(state)
    rank = _group_rank() if sharding.is_placed(state) else None
    if rank not in (None, 0):
        for _, x in flat:
            if sharding.is_dtensor(x):
                x.full_tensor()  # this rank's part of the gather; rank 0 keeps it
        if blocking:
            torch.distributed.barrier()
        return None
    snaps = [_snapshot(x) for _, x in flat]
    d = os.path.join(ckpt_dir, f"step_{step:06d}")
    os.makedirs(d, exist_ok=True)

    def _write():
        np.savez(os.path.join(d, f"shard_{host}.npz"),
                 **{f"leaf_{i}": a for i, (a, _) in enumerate(snaps)})
        manifest = {
            "step": step,
            "paths": [path_str(p) for p, _ in flat],
            "shapes": [list(a.shape) for a, _ in snaps],
            "dtypes": [name for _, name in snaps],
        }
        with open(os.path.join(d, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(d, "COMMIT"), "w") as f:
            f.write("ok")

    if blocking:
        _write()
        if rank is not None:
            torch.distributed.barrier()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "COMMIT")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _decode(raw: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    want = np.dtype(dtype_name)
    if raw.dtype != want and raw.dtype.kind in "ui":
        raw = raw.view(want)
    return torch.from_numpy(raw)


def restore(ckpt_dir: str, like, step: int | None = None, shardings=None, host: int = 0,
            mesh=None):
    """Restore into the structure of ``like``: (tree, step), or (None, None)
    when ``ckpt_dir`` holds no committed step.  Each leaf comes back as a
    tensor of the saved dtype, on the device of the ``like`` leaf it
    replaces (the CPU where that is not a tensor).  The manifest's paths
    and shapes must be ``like``'s, else ``ValueError``.  ``shardings`` (a
    tree of specs for ``like``, ``train.sharding``'s rules) places the
    leaves on the ``DeviceMesh`` ``mesh``; without it a leaf whose ``like``
    leaf is a DTensor is placed as that one is."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None, None
    d = os.path.join(ckpt_dir, f"step_{step:06d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = flatten_with_path(like)
    paths = [path_str(p) for p, _ in flat]
    shapes = [list(np.shape(x)) for _, x in flat]
    if manifest["paths"] != paths or manifest["shapes"] != shapes:
        raise ValueError(f"checkpoint {d} does not match the tree to restore into: "
                         f"paths {manifest['paths'] == paths}, shapes "
                         f"{manifest['shapes'] == shapes} equal")
    new = []
    with np.load(os.path.join(d, f"shard_{host}.npz")) as data:
        for i, (_, x) in enumerate(flat):
            t = _decode(data[f"leaf_{i}"], manifest["dtypes"][i])
            if isinstance(x, torch.Tensor):
                t = t.to(x.device)
                if sharding.is_dtensor(x) and shardings is None:
                    t = _dtensor_like(t, x)
            new.append(t)
    tree = unflatten(like, new)
    if shardings is not None:
        tree = sharding.place(tree, shardings, mesh)
    return tree, step


def _dtensor_like(t: torch.Tensor, x):
    """The full tensor ``t`` placed as the DTensor ``x`` is."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, x.device_mesh, x.placements, src_data_rank=None)


def prune(ckpt_dir: str, keep: int = 3):
    """Drop all but the newest ``keep`` committed checkpoints (and any
    uncommitted partials older than the newest committed one)."""
    if not os.path.isdir(ckpt_dir):
        return
    entries = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if not m:
            continue
        committed = os.path.exists(os.path.join(ckpt_dir, name, "COMMIT"))
        entries.append((int(m.group(1)), name, committed))
    committed = sorted([e for e in entries if e[2]], reverse=True)
    for step, name, _ in committed[keep:]:
        shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
    for step, name, ok in entries:
        if not ok and committed and step < committed[0][0]:
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
