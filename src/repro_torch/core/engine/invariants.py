"""Per-kernel invariant cache (the engine's memoization layer).

Structural computations — footprint boxes, wave sets, layer-set footprints,
grid walks — are pure functions of ``(spec, block extent, grid, machine
geometry)``.  The paper's 1024-thread configuration grid has heavy structural
overlap: different (block, folding) pairs fold to the same block extent, and
machines differing only in cache sizes share every count.  The cache stores
each value once under its structural key; errors are cached too, so a whole
family of configurations sharing a degenerate extent is skipped in O(1).

Entries are ``("ok", value)`` or ``("err", exception)`` outcome pairs — the
same shape the worker pool returns — so pool results can be stored verbatim.

Persistence (DESIGN.md §5, §15): structural keys are pure value tuples
(frozen dataclasses hash and compare by value across processes), so the
cache can be written to disk and reloaded by a later run.  The on-disk
format is a *base blob plus an append-only journal*:

* the base blob is a content-addressed snapshot: a header pickle
  ``{magic, version}``, then ``digest = sha256(magic || version ||
  payload)``, then ``payload = pickle([(key, outcome), ...])`` — one pickle
  for all entries, so keys sharing sub-objects (every config of one kernel
  embeds the same spec tree) are stored once and reload as shared objects;
* ``<path>.journal`` holds sha256-framed segments (:mod:`repro_torch.durable`),
  one appended per ``save()`` with only the entries added since the last
  persist — a sweep's results commit with one fsync'd append instead of a
  rewrite of the whole store.

Loads replay base + journal; when the journal grows past a threshold (or
after eviction/merge made the journal no longer a pure suffix of the
in-memory store) ``save()`` *compacts*: the full store is rewritten as one
atomic base blob and the journal is deleted.  The digest binds every
payload to ``ENGINE_CACHE_VERSION``: a cache written by an engine with
different task semantics, and any corrupted or truncated payload, is
rejected wholesale — loads never raise on bad files, they just come back
cold.  Base writes are atomic (:func:`repro_torch.durable.atomic_write`).

``merge()`` folds other cache files (base + journal each) into this one —
the multi-host shard format: N hosts sweep disjoint slices against
``cache.shard<i>`` paths, then one host merges and compacts.

Self-healing (DESIGN.md §13): a blob that fails the magic or digest check
is *quarantined* — renamed to ``<path>.corrupt`` so the next save rebuilds
a clean file and the damaged one stays on disk for diagnosis — and counted
in ``health["corrupt_quarantined"]``.  A version-mismatched blob is left in
place (an older engine may still want it) but counted in
``health["version_skew"]``.  A journal with a torn tail is truncated back
to its committed prefix (tail quarantined to ``<path>.journal.tail``) and
counted in ``health["journal_torn"]``.  Either way the load comes back
cold for the damaged suffix, never wrong.

A copy of ``repro.core.engine.invariants`` with a magic of its own: the
entries' pickles name the port's classes, so a file written by the port is
not one the reference may read, nor the reverse.  A blob or journal segment
carrying the reference's magic counts as ``version_skew`` and is left in
place, never unpickled past its header; a journal segment starts with the
raw magic bytes, then the header's pickle and the records' pickle, so no
byte of another engine's segment is ever unpickled.  ``ENGINE_CACHE_VERSION`` keeps the reference's
value: the task set and key schema are the same.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import os
import pickle
import threading
from typing import Hashable, Iterable

from repro_torch import durable, faults, obs

# Bump whenever a structural task's semantics, arguments, or key schema
# change: the digest of every persisted entry covers this value, so caches
# from older engines are ignored (not migrated) on load.  History:
#   1 — PR 1 task set (gpu-block / gpu-walk / gpu-wave / pallas)
#   2 — tiered task set (gpu-wave split into front + overlap for the
#       bound-then-refine search)
#   3 — geometry-factored keys: wave keys/args carry GPUGeometry objects
#       (not ad-hoc tuples / whole machines) and the machine-axis path adds
#       the geometry-keyed pallas-struct task (DESIGN.md §11)
ENGINE_CACHE_VERSION = 3

_MAGIC = b"repro_torch-invariant-cache"
# the reference engine's magic: its files are foreign here, not damaged
_FOREIGN_MAGICS = (b"repro-invariant-cache",)
# raw tag that opens every journal segment, checked before any unpickling
_SEGMENT_TAG = _MAGIC + b"\x00"


def _digest(payload: bytes) -> bytes:
    h = hashlib.sha256()
    h.update(_MAGIC)
    h.update(str(ENGINE_CACHE_VERSION).encode())
    h.update(payload)
    return h.digest()


class InvariantCache:
    """Outcome store keyed by structural keys, with hit/miss accounting.

    ``path`` enables persistence: the constructor loads any compatible
    entries found there, and ``save()`` (called by the Explorer after each
    sweep that added entries) atomically rewrites the file.

    ``max_entries``/``max_bytes`` bound memory for unbounded design-space
    sweeps: above either budget the least-recently-used entries are evicted
    (disk-loaded entries never probed this process go first), counted in
    ``evictions``/``evicted_bytes``.  Eviction only costs recomputation —
    correctness is unaffected.  Byte accounting uses each record's pickled
    size (measured only when ``max_bytes`` is set; unpicklable outcomes are
    charged a nominal size).
    """

    _NOMINAL_RECORD_BYTES = 1024
    # journal growth bounds: past either, the next save compacts the base
    # blob instead of appending another segment (class attributes so tests
    # can tighten them)
    _COMPACT_SEGMENTS = 64
    _COMPACT_BYTES = 16 << 20

    def __init__(self, path: str | os.PathLike | None = None, *,
                 max_entries: int | None = None,
                 max_bytes: int | None = None):
        self._store: dict = {}
        # entries restored from disk wait here and migrate to ``_store``
        # under the *caller's* key object on first probe: unpickled keys
        # deep-compare their whole spec trees on every dict probe, while
        # this process's keys share interned spec objects (identity-fast
        # equality) — lazy re-keying makes warm sweeps probe at full speed
        self._loaded: dict = {}
        self.hits = 0
        self.misses = 0
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.evictions = 0
        self.evicted_bytes = 0
        self._held = 0
        self._hold_lock = threading.RLock()
        self._bytes = 0
        self._sizes: dict = {}      # key -> record bytes (max_bytes only)
        self.path = os.fspath(path) if path is not None else None
        self._dirty = False
        # keys added since the last persist, in insertion order — exactly
        # what the next save() appends as one journal segment
        self._new: dict = {}
        # set when the journal can no longer be a pure suffix of the store
        # (eviction dropped persisted entries, clear(), merge()): the next
        # save() must compact instead of appending
        self._force_compact = False
        self.journal_segments = 0
        self.compactions = 0
        self.health = {"corrupt_quarantined": 0, "version_skew": 0,
                       "load_errors": 0, "journal_torn": 0}
        self.loaded_entries = 0
        if self.path:
            self.loaded_entries = self.load()
            self._evict_over_budget()

    @property
    def journal_path(self) -> str | None:
        return self.path + ".journal" if self.path else None

    def __contains__(self, key: Hashable) -> bool:
        return key in self._store or key in self._loaded

    def __len__(self) -> int:
        return len(self._store) + len(self._loaded)

    @property
    def _bounded(self) -> bool:
        return self.max_entries is not None or self.max_bytes is not None

    def _get(self, key: Hashable):
        out = self._store.get(key)
        if out is None and self._loaded:
            out = self._loaded.pop(key, None)
            if out is not None:
                self._store[key] = out      # re-keyed: one slow probe ever
        elif out is not None and self._bounded:
            # LRU bookkeeping (dicts preserve insertion order; re-inserting
            # moves the entry to the recent end) — only paid under a budget
            del self._store[key]
            self._store[key] = out
        return out

    def _record_bytes(self, key: Hashable, outcome) -> int:
        try:
            return len(pickle.dumps((key, outcome),
                                    protocol=pickle.HIGHEST_PROTOCOL))
        except Exception:
            return self._NOMINAL_RECORD_BYTES

    @contextlib.contextmanager
    def hold(self):
        """Defer eviction while a sweep is in flight.

        The explorer stores task outcomes during resolution and reads them
        back (``peek``) during result assembly; an eviction in between
        would drop a value before it is consumed.  Budgets therefore apply
        *between* sweeps: on exiting the outermost hold, the cache evicts
        down to budget in one pass.  Nesting-safe, and thread-safe: holds
        taken by concurrent sweeps (threads sharing one cache) balance
        under a lock, so no thread evicts while
        another's sweep is in flight.
        """
        with self._hold_lock:
            self._held += 1
        try:
            yield self
        finally:
            with self._hold_lock:
                self._held -= 1
                if self._held == 0:
                    self._evict_over_budget()

    def _evict_over_budget(self) -> None:
        # under the hold lock: a concurrent hold() must not observe (and a
        # concurrent store() must not interleave with) a half-done eviction
        with self._hold_lock:
            if not self._bounded or self._held:
                return

            def over() -> bool:
                if (self.max_entries is not None
                        and len(self) > self.max_entries):
                    return True
                return (self.max_bytes is not None
                        and self._bytes > self.max_bytes)

            while over():
                # disk-loaded entries never probed this process are the
                # coldest; then the least recently used live entry
                # (insertion-ordered)
                source = self._loaded if self._loaded else self._store
                if not source:
                    break
                key = next(iter(source))
                del source[key]
                size = self._sizes.pop(key, 0)
                self._bytes -= size
                self.evictions += 1
                self.evicted_bytes += size
                self._dirty = True
                if self._new.pop(key, None) is None:
                    # a *persisted* entry left the store: the disk now holds
                    # more than memory, so the next save must compact (an
                    # append-only journal cannot express a removal)
                    self._force_compact = True

    def lookup(self, key: Hashable):
        """Return the cached outcome pair or None, counting a hit (a task
        evaluation avoided) or a miss (a task that must be computed)."""
        out = self._get(key)
        if out is None:
            self.misses += 1
        else:
            self.hits += 1
        return out

    def peek(self, key: Hashable):
        """Uncounted read — for result assembly, not sharing decisions."""
        return self._get(key)

    def count_hit(self) -> None:
        """Record sharing that bypasses the store (intra-sweep dedupe of a
        task already queued for evaluation)."""
        self.hits += 1

    def store(self, key: Hashable, outcome: tuple) -> None:
        if not self._bounded:
            self._store[key] = outcome
            self._new[key] = None
            self._dirty = True
            return
        # bounded caches serialize stores against hold()/eviction: a store
        # racing an eviction pass must never land between the budget check
        # and the deletions (it could be evicted before its sweep reads it)
        with self._hold_lock:
            self._store[key] = outcome
            self._new[key] = None
            self._dirty = True
            if self.max_bytes is not None:
                size = self._record_bytes(key, outcome)
                self._bytes += size - self._sizes.get(key, 0)
                self._sizes[key] = size
            self._evict_over_budget()

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self), "evictions": self.evictions,
                "evicted_bytes": self.evicted_bytes,
                "journal_segments": self.journal_segments,
                "compactions": self.compactions,
                "health": dict(self.health)}

    def clear(self) -> None:
        self._store.clear()
        self._loaded.clear()
        self._sizes.clear()
        self._new.clear()
        self._bytes = 0
        self.hits = self.misses = 0
        self._dirty = True
        self._force_compact = True

    # ---- persistence ---------------------------------------------------
    def _adopt(self, records) -> int:
        """Fold decoded ``(key, outcome)`` records into the lazy side of
        the store; return how many were new."""
        loaded = 0
        for record in records if isinstance(records, list) else []:
            try:
                key, outcome = record
                if key not in self._store and key not in self._loaded:
                    self._loaded[key] = outcome
                    if self.max_bytes is not None:
                        size = self._record_bytes(key, outcome)
                        self._sizes[key] = size
                        self._bytes += size
                    loaded += 1
            except Exception:
                continue
        return loaded

    def load(self, path: str | None = None) -> int:
        """Merge compatible entries from disk; return how many were added.

        Replays the base blob, then every committed journal segment at
        ``<path>.journal``.  Corruption-tolerant by construction: an
        unreadable file, a foreign or version-mismatched header, a payload
        whose content digest does not verify, and a torn journal tail all
        degrade to "fewer cached entries", never to an exception — a cold
        run is always correct, just slower.  Corrupt blobs are quarantined
        to ``<path>.corrupt`` and torn journal tails to
        ``<path>.journal.tail`` so the next ``save`` starts clean while
        the evidence survives (health counters record every case).
        """
        path = path or self.path
        if not path:
            return 0
        own = path == self.path
        with obs.span("durable.recover", cat="cache", path=path):
            added = self._load_blob(path)
            added += self._load_journal(path + ".journal", own=own)
        return added

    def _load_blob(self, path: str) -> int:
        if not os.path.exists(path):
            return 0
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            self.health["load_errors"] += 1
            return 0
        # fault-injection site: bit rot between write and read-back
        raw = faults.corrupt_bytes("invcache.load", raw)
        try:
            buf = io.BytesIO(raw)
            header = pickle.load(buf)
            if isinstance(header, dict) and (
                    header.get("magic") in _FOREIGN_MAGICS):
                # another engine's cache: leave the file alone
                self.health["version_skew"] += 1
                return 0
            if not (isinstance(header, dict)
                    and header.get("magic") == _MAGIC):
                self._quarantine(path)
                return 0
            if header.get("version") != ENGINE_CACHE_VERSION:
                # legitimately foreign, not damaged: leave the file alone
                self.health["version_skew"] += 1
                return 0
            digest = pickle.load(buf)
            payload = buf.read()
            if _digest(payload) != digest:
                self._quarantine(path)
                return 0
            records = pickle.loads(payload)
        except Exception:
            self._quarantine(path)
            return 0
        return self._adopt(records)

    def _load_journal(self, jpath: str, *, own: bool) -> int:
        """Replay committed journal segments.  The cache's own journal is
        recovered in place (torn tail truncated + quarantined, so appends
        can continue); a foreign shard's journal is scanned read-only."""
        if not os.path.exists(jpath):
            return 0
        if own:
            payloads, torn = durable.Journal(jpath).recover()
        else:
            payloads, _, torn = durable.scan(jpath)
        if torn:
            self.health["journal_torn"] += 1
        added = 0
        segments = 0
        for raw in payloads:
            if not raw.startswith(_SEGMENT_TAG):
                # another engine's segment (its magic sits in the first
                # bytes of its pickle) is foreign; anything else is damage
                foreign = any(m in raw[:64] for m in _FOREIGN_MAGICS)
                self.health["version_skew" if foreign else "load_errors"] += 1
                continue
            buf = io.BytesIO(raw)
            buf.seek(len(_SEGMENT_TAG))
            try:
                seg = pickle.load(buf)
            except Exception:
                self.health["load_errors"] += 1
                continue
            if not (isinstance(seg, dict) and seg.get("magic") == _MAGIC):
                self.health["load_errors"] += 1
                continue
            if seg.get("version") != ENGINE_CACHE_VERSION:
                self.health["version_skew"] += 1
                continue
            try:
                records = pickle.load(buf)
            except Exception:
                self.health["load_errors"] += 1
                continue
            added += self._adopt(records)
            segments += 1
        if own:
            self.journal_segments = segments
        return added

    def merge(self, shard_paths: Iterable[str | os.PathLike]) -> int:
        """Fold other cache files (base + journal each) into this cache —
        the multi-host format: each host sweeps its slice against its own
        shard path, then one merge produces the union.  Returns how many
        entries were new; the next ``save()`` compacts so the merged store
        lands in this cache's own base blob."""
        added = 0
        for p in shard_paths:
            added += self.load(os.fspath(p))
        if added:
            self._dirty = True
            self._force_compact = True
        return added

    def _quarantine(self, path: str) -> None:
        """Move a damaged blob aside so the next save starts clean while
        the evidence survives for diagnosis."""
        self.health["corrupt_quarantined"] += 1
        try:
            os.replace(path, path + ".corrupt")
        except OSError:
            pass

    def _pickle_records(self, records) -> bytes | None:
        try:
            return pickle.dumps(records, protocol=pickle.HIGHEST_PROTOCOL)
        except Exception:
            # drop individually unpicklable entries (exotic cached
            # exceptions), then retry once
            safe = []
            for record in records:
                try:
                    pickle.dumps(record, protocol=pickle.HIGHEST_PROTOCOL)
                except Exception:
                    continue
                safe.append(record)
            records[:] = safe
            try:
                return pickle.dumps(records,
                                    protocol=pickle.HIGHEST_PROTOCOL)
            except Exception:
                return None

    def save(self, path: str | None = None) -> int:
        """Durably persist changes; return how many entries were written.

        Normally an *incremental* commit: the entries added since the last
        persist go out as one fsync'd journal segment.  Falls back to a
        full compaction when there is no base blob yet, when the journal
        outgrew its bounds (``_COMPACT_SEGMENTS`` / ``_COMPACT_BYTES``), or
        when eviction/clear/merge made the journal no longer a pure suffix
        of the store.  Entries that cannot be pickled are dropped silently
        — the persistent cache is an accelerator, not a database.
        """
        path = path or self.path
        if not path:
            return 0
        if path != self.path:
            # saving a copy elsewhere: ``_new``/segment accounting describe
            # this cache's own journal, so a foreign path gets a full blob
            return self.compact(path)
        new = []
        for key in self._new:
            outcome = self._store.get(key, self._loaded.get(key))
            if outcome is not None:
                new.append((key, outcome))
        journal = durable.Journal(path + ".journal")
        if (self._force_compact
                or not os.path.exists(path)
                or self.journal_segments + 1 > self._COMPACT_SEGMENTS
                or journal.size() > self._COMPACT_BYTES):
            return self.compact(path)
        if not new:
            if self._dirty:
                return self.compact(path)
            return 0
        # _pickle_records prunes unpicklable entries from ``new`` in place,
        # so the segment envelope below can only fail for OS-level reasons
        if self._pickle_records(new) is None:
            return 0
        try:
            segment = _SEGMENT_TAG + pickle.dumps(
                {"magic": _MAGIC, "version": ENGINE_CACHE_VERSION},
                protocol=pickle.HIGHEST_PROTOCOL) + pickle.dumps(
                new, protocol=pickle.HIGHEST_PROTOCOL)
            journal.append(segment)
        except (OSError, pickle.PicklingError):
            return 0
        self.journal_segments += 1
        self._new.clear()
        self._dirty = False
        return len(new)

    def compact(self, path: str | None = None) -> int:
        """Rewrite the full store as one atomic base blob and delete the
        journal; return how many entries were written."""
        path = path or self.path
        if not path:
            return 0
        with obs.span("cache.compaction", cat="cache", path=path,
                      segments=self.journal_segments):
            records = [(key, outcome)
                       for source in (self._store, self._loaded)
                       for key, outcome in source.items()]
            payload = self._pickle_records(records)
            if payload is None:
                return 0
            buf = io.BytesIO()
            pickle.dump({"magic": _MAGIC,
                         "version": ENGINE_CACHE_VERSION}, buf)
            pickle.dump(_digest(payload), buf)
            buf.write(payload)
            try:
                durable.atomic_write(path, buf.getvalue())
            except OSError:
                return 0
            durable.Journal(path + ".journal").remove()
            self.journal_segments = 0
            self.compactions += 1
            if path == self.path:
                self._new.clear()
                self._dirty = False
                self._force_compact = False
            return len(records)

    @property
    def dirty(self) -> bool:
        """True when entries were added since the last successful save."""
        return self._dirty
