"""Durability primitives: atomic writes and an append-only framed journal.

A copy of ``repro.durable``; the frame format is the same.

Everything in the pricing stack that survives a process death goes through
this module (DESIGN.md §15).  Two disciplines, two commit points:

*Atomic replace* (:func:`atomic_write`) — for files whose value is their
*latest complete state*: the invariant-cache base blob, bench JSON,
exported traces, memo snapshots.  The data is written to a temp file in the
target directory, fsync'd, ``os.replace``'d over the destination, and the
parent directory is fsync'd so the rename itself is durable.  A crash at
any point leaves either the old complete file or the new complete file.

*Append-only journal* (:class:`Journal`) — for state that accretes: sweep
checkpoints and invariant-cache segments.  Each record is one self-checking
frame::

    MAGIC(4) | length u32 LE | sha256(payload)(32) | payload

The commit point is the ``flush`` + ``fsync`` at the end of
:meth:`Journal.append`: a frame is durable iff the call returned.  On
replay (:func:`scan` / :meth:`Journal.recover`) the file is read frame by
frame; the first frame that fails the magic, length, or digest check ends
the committed prefix.  Recovery truncates the file back to that prefix and
quarantines the torn tail to ``<path>.tail`` for diagnosis — a kill or a
torn write can lose at most the record that was mid-commit, never a
committed one, and never yields a wrong record (the digest rejects partial
or bit-rotted payloads).

Fault sites (DESIGN.md §13): ``io.torn_write`` makes :meth:`Journal.append`
write only a prefix of the frame and then *report success* — the
lying-filesystem model — and ``proc.kill`` (a SIGKILL
:func:`repro_torch.faults.kill_point`) fires after each commit, so plans can die
at exact journal indices.

This module depends only on the stdlib and :mod:`repro_torch.faults` so every
layer (obs, benchmarks, engine, serve) can use it without import cycles;
telemetry spans around recovery/compaction live at the call sites.
"""
from __future__ import annotations

import hashlib
import os
import struct
import tempfile

from repro_torch import faults

FRAME_MAGIC = b"RJ1\x00"
_HEADER = struct.Struct("<4sI32s")     # magic, payload length, sha256
FRAME_OVERHEAD = _HEADER.size

#: hard ceiling on a single frame payload — a corrupted length prefix must
#: not make replay attempt a multi-gigabyte read
MAX_FRAME_BYTES = 1 << 30


def fsync_dir(path: str) -> None:
    """Fsync a directory so a rename/creat inside it is durable.  Best
    effort: some filesystems refuse O_RDONLY dir fsync — a failure degrades
    to "as durable as before", never to an exception."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path: str | os.PathLike, data: bytes | str, *,
                 sync: bool = True) -> str:
    """Atomically replace ``path`` with ``data``; return the path written.

    Temp file in the same directory -> write -> fsync(file) ->
    ``os.replace`` -> fsync(parent dir).  Readers never observe a partial
    file, and once this returns the new content survives power loss.
    ``sync=False`` skips both fsyncs for callers that only need atomicity.
    """
    path = os.fspath(path)
    if isinstance(data, str):
        data = data.encode("utf-8")
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".durable-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            if sync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if sync:
        fsync_dir(d)
    return path


def frame(payload: bytes) -> bytes:
    """One self-checking journal frame for ``payload``."""
    return _HEADER.pack(FRAME_MAGIC, len(payload),
                        hashlib.sha256(payload).digest()) + payload


def frames(payloads) -> bytes:
    """A whole journal body (e.g. for a compacted rewrite)."""
    return b"".join(frame(p) for p in payloads)


def scan(path: str | os.PathLike) -> tuple[list[bytes], int, bool]:
    """Replay a journal file without modifying it.

    Returns ``(payloads, valid_bytes, torn)``: every frame of the committed
    prefix, the byte offset where that prefix ends, and whether trailing
    bytes beyond it exist (a torn or corrupt tail).  A missing file is an
    empty, un-torn journal.
    """
    path = os.fspath(path)
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return [], 0, False
    payloads: list[bytes] = []
    off = 0
    while off + FRAME_OVERHEAD <= len(raw):
        magic, length, digest = _HEADER.unpack_from(raw, off)
        if magic != FRAME_MAGIC or length > MAX_FRAME_BYTES:
            break
        start = off + FRAME_OVERHEAD
        end = start + length
        if end > len(raw):
            break                       # torn mid-payload
        payload = raw[start:end]
        if hashlib.sha256(payload).digest() != digest:
            break
        payloads.append(payload)
        off = end
    return payloads, off, off < len(raw)


class Journal:
    """Append-only record log over one file; safe to reopen after a kill.

    ``append`` is the commit: open in append mode, write one frame, flush,
    fsync.  ``recover`` replays the committed prefix, truncates any torn
    tail (quarantining it to ``<path>.tail``), and leaves the file ready
    for further appends.  Instances are cheap — no file handle is held
    between appends, so a SIGKILL between calls never corrupts state.
    """

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self.appended = 0

    def append(self, payload: bytes) -> int:
        """Durably append one record; return its frame index this process.

        Carries two fault sites: ``io.torn_write`` writes only a prefix of
        the frame and still returns (the lying filesystem), and
        ``proc.kill`` SIGKILLs the process *after* the commit — so a plan
        ``at=(k,)`` dies with exactly ``k + 1`` frames durable.
        """
        data = frame(payload)
        if faults.fire("io.torn_write") is not None:
            data = data[:max(1, len(data) // 2)]
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        with open(self.path, "ab") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        index = self.appended
        self.appended += 1
        faults.kill_point("proc.kill")
        return index

    def recover(self, *, quarantine: bool = True) -> tuple[list[bytes], bool]:
        """Replay the committed prefix and truncate any torn tail.

        Returns ``(payloads, torn)``.  When ``quarantine`` is set the torn
        tail bytes are preserved at ``<path>.tail`` before truncation so
        the evidence survives for diagnosis.
        """
        payloads, valid, torn = scan(self.path)
        if torn:
            try:
                with open(self.path, "rb") as f:
                    f.seek(valid)
                    tail = f.read()
                if quarantine and tail:
                    atomic_write(self.path + ".tail", tail)
                with open(self.path, "rb+") as f:
                    f.truncate(valid)
                    f.flush()
                    os.fsync(f.fileno())
            except OSError:
                pass
        return payloads, torn

    def rewrite(self, payloads) -> int:
        """Atomically replace the whole journal (compaction); returns the
        number of frames written.  Any stale ``.tail`` quarantine is left
        in place — it describes a previous incident, not this file."""
        payloads = list(payloads)
        atomic_write(self.path, frames(payloads))
        return len(payloads)

    def size(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def remove(self) -> None:
        """Delete the journal file (after its contents were folded into a
        compacted base); durable against the directory."""
        try:
            os.unlink(self.path)
        except OSError:
            return
        fsync_dir(os.path.dirname(os.path.abspath(self.path)))


__all__ = [
    "FRAME_MAGIC", "FRAME_OVERHEAD", "MAX_FRAME_BYTES",
    "atomic_write", "fsync_dir", "frame", "frames", "scan", "Journal",
]
