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
from repro_torch.tree import flatten_with_path, path_str, unflatten


def _snapshot(x) -> tuple:
    """(a host copy of ``x`` that numpy can save, its dtype's name as the
    manifest writes it)."""
    t = torch.as_tensor(x)
    a = numpy_copy(t)
    return a, "bfloat16" if t.dtype == torch.bfloat16 else str(a.dtype)


def save(ckpt_dir: str, step: int, state, host: int = 0, blocking: bool = True):
    """Save a tree ``state`` (tensors on any device, or what
    ``torch.as_tensor`` takes).  Returns None, or with ``blocking=False``
    the writing thread (join() it); either way every leaf was copied to the
    host before it returns."""
    d = os.path.join(ckpt_dir, f"step_{step:06d}")
    os.makedirs(d, exist_ok=True)
    flat = flatten_with_path(state)
    snaps = [_snapshot(x) for _, x in flat]

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


def restore(ckpt_dir: str, like, step: int | None = None, host: int = 0):
    """Restore into the structure of ``like``: (tree, step), or (None, None)
    when ``ckpt_dir`` holds no committed step.  Each leaf comes back as a
    tensor of the saved dtype, on the device of the ``like`` leaf it
    replaces (the CPU where that is not a tensor).  The manifest's paths
    and shapes must be ``like``'s, else ``ValueError``.  (The reference's
    ``shardings`` argument places leaves on a mesh; on one card there is
    nothing to place.)"""
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
            new.append(t.to(x.device) if isinstance(x, torch.Tensor) else t)
    return unflatten(like, new), step


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
