"""Request scheduler: dedupe, memoization, and sweep coalescing.

The daemon's brain, usable in-process too.  Every submitted
``PriceRequest`` is identified by its structural digest
(``schema.request_digest``); the scheduler then guarantees each distinct
digest is **priced at most once** while it stays memoized:

  * **memo hit** — a digest priced before resolves immediately from an LRU
    result memo (no engine work, no queue: this is the single-digit-ms warm
    path the soak benchmark gates);
  * **in-flight join** — a digest currently being priced attaches to the
    existing computation's future instead of enqueueing again (concurrent
    identical clients collapse structurally, the way suite lowering
    collapses repeated cells);
  * **coalesced sweep** — distinct queued requests with compatible sweep
    parameters (same machines/top_k/strict/machine_axis/gpu_configs, no
    suite plans) merge into ONE engine sweep under ``q<i>::`` workload
    prefixes, then split back per request — sharing the invariant cache,
    cell dedupe, and pool batching across clients.

Robustness (DESIGN.md §13):

  * **bounded queue** — with ``max_queue`` set, a submission that would
    grow the queue past the bound is rejected with ``QueueFullError``
    (carrying a ``retry_after_s`` hint) instead of queueing unboundedly;
    memo hits and in-flight joins are never rejected (they cost no sweep);
  * **per-request deadlines** — a request carrying ``deadline_s`` that
    cannot finish its exact sweep in time resolves to the tier-1
    closed-form bound ranking (``repro_torch.api.price_bounds``) flagged
    ``degraded=True`` — an explicit, sound, cheap answer instead of a
    timeout.  Degraded results are never memoized (a later undeadlined ask
    gets the exact sweep) and deadline requests never coalesce;
  * **cancellation** — ``cancel(fut)`` detaches a waiter whose client went
    away; a queued request all of whose waiters cancelled is dropped
    before any engine work runs;
  * **durable memo** (DESIGN.md §15) — with ``memo_path`` set, every
    memoized ``[digest, wire]`` pair appends to a versioned
    :mod:`repro_torch.durable` journal the moment it resolves, and
    ``restore_memo=True`` replays it at boot (``memo_restored`` counter) —
    so even a SIGKILL'd daemon restarts warm, losing at most the entry
    that was mid-commit.  A graceful ``shutdown`` compacts the journal to
    ``snapshot_memo()`` (header + live memo, atomically replaced).

Counters make all of this observable (and gateable): ``requests =
memo_hits + dedupe_joins + keys_priced + cancelled`` holds once the queue
drains, and the *live* form ``requests = memo_hits + dedupe_joins +
keys_priced + cancelled + pending`` holds at any instant of a ``stats()``
snapshot (``pending`` counts accepted digests not yet resolved;
``cancelled`` counts requests dropped before pricing; degraded
resolutions are ordinary ``keys_priced``).  Rejected submissions are
counted separately — they were never accepted as requests.  The counters
live in a documented ``repro_torch.obs.metrics.CounterGroup`` (``serve.*``), so
they also surface in ``obs.metrics.snapshot()`` and the daemon's ``stats``
op.

A copy of ``repro.serve.scheduler``: the same counters, spans, memo journal
(its header too, so a journal one package's daemon wrote restores in the
other's) and coalescing, except that a request filling a field the port's
``price`` refuses (``api.NOT_PORTED``) is served solo, so it fails alone
and never sinks the requests it would have merged with.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future

from repro_torch import durable, obs
from repro_torch.api import NOT_PORTED, PriceRequest, PriceResult, price, price_bounds
from repro_torch.obs.metrics import CounterGroup
from repro_torch.core.engine import (
    EvalResult,
    ExplorationReport,
    Explorer,
    PrunedConfig,
    SkippedConfig,
)

from .schema import SCHEMA_VERSION, dumps, encode, loads, request_digest

# memo journal framing (DESIGN.md §15): frame 0 is this versioned header,
# every later frame is one ``[digest, wire]`` pair appended the moment a
# digest memoizes — so even a SIGKILL'd daemon loses at most the entry that
# was mid-commit, and a ``--resume`` boot restores the warm memo verbatim
_MEMO_KIND = "repro-memo-journal"
_MEMO_VERSION = 1


def _memo_header() -> bytes:
    return json.dumps({"kind": _MEMO_KIND, "version": _MEMO_VERSION,
                       "schema_version": SCHEMA_VERSION},
                      separators=(",", ":")).encode()


class QueueFullError(RuntimeError):
    """Backpressure: the scheduler queue is at its bound.

    ``retry_after_s`` estimates when capacity should free up — clients
    (``PriceClient`` does this automatically) should back off at least
    that long and resubmit; the request digest makes the retry idempotent.
    """

    def __init__(self, message: str, retry_after_s: float = 0.1):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class DeadlineExceeded(RuntimeError):
    """Internal: raised out of the engine's progress callback to abandon
    an exact sweep whose request deadline has passed."""


class _Memo:
    """One memoized result + its lazily rendered wire text."""

    __slots__ = ("result", "wire")

    def __init__(self, result):
        self.result = result
        self.wire = None


class _Pending:
    """One in-flight digest: the request and every future joined to it.

    ``deadline`` is an absolute ``time.monotonic()`` instant (None for
    no deadline) — absolute so queue wait counts against it.
    """

    __slots__ = ("digest", "request", "futures", "deadline")

    def __init__(self, digest, request, deadline=None):
        self.digest = digest
        self.request = request
        self.futures: list = []
        self.deadline = deadline


def _coalesce_key(request: PriceRequest):
    """Requests sharing this key can merge into one sweep (suite plans are
    already one sweep internally and keep their own fold, so they never
    coalesce with others; nor does a request that ``price`` refuses, whose
    error would otherwise resolve every request merged with it)."""
    if request.plans or any(getattr(request, f) for f in NOT_PORTED):
        return None
    body = encode((request.machines, request.gpu_configs, request.top_k,
                   request.strict, request.machine_axis))
    return json.dumps(body, separators=(",", ":"), sort_keys=True)


def _prefixed(request: PriceRequest, tag: str) -> PriceRequest:
    return PriceRequest(
        workloads=tuple(dataclasses.replace(w, name=f"{tag}{w.name}")
                        for w in request.workloads),
        traced=tuple(dataclasses.replace(t, name=f"{tag}{t.name}")
                     for t in request.traced),
        machines=request.machines, gpu_configs=request.gpu_configs,
        top_k=request.top_k, strict=request.strict,
        machine_axis=request.machine_axis,
    )


def _split_report(merged, tag: str) -> ExplorationReport:
    """Extract one request's rows from a coalesced report, prefix stripped.

    Estimates are the merged sweep's objects untouched — workload names are
    labels, not pricing inputs (``_cell_signature`` never reads them), so
    the split rows are bitwise identical to a solo sweep's.
    """
    n = len(tag)
    out = ExplorationReport(
        entries=[EvalResult(e.workload[n:], e.machine, e.backend, e.index,
                            e.config, e.estimate, e.perf, e.limiter)
                 for e in merged.entries if e.workload.startswith(tag)],
        skipped=[SkippedConfig(s.workload[n:], s.machine, s.config, s.reason)
                 for s in merged.skipped if s.workload.startswith(tag)],
        pruned=[PrunedConfig(p.workload[n:], p.machine, p.config, p.bound,
                             p.threshold)
                for p in merged.pruned if p.workload.startswith(tag)],
        cache_stats=dict(merged.cache_stats),
        wall_time_s=merged.wall_time_s,
        metrics=dict(merged.metrics),
    )
    out.cache_stats["coalesced"] = True
    out.metrics["serve.coalesced"] = 1
    return out


class Scheduler:
    """Thread-safe pricing scheduler over one shared ``Explorer``."""

    def __init__(self, engine: Explorer | None = None, *,
                 memo_entries: int = 1024, coalesce: bool = True,
                 max_queue: int | None = None,
                 default_deadline_s: float | None = None,
                 memo_path: str | os.PathLike | None = None,
                 restore_memo: bool = False):
        self.engine = engine or Explorer()
        self.memo_entries = memo_entries
        self.coalesce = coalesce
        self.max_queue = max_queue
        self.default_deadline_s = default_deadline_s
        self._memo: OrderedDict = OrderedDict()   # digest -> _Memo (LRU)
        self._inflight: dict = {}                 # digest -> _Pending
        self._queue: list = []                    # _Pending FIFO
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._stop = False
        self.counters = CounterGroup("serve", {
            "requests": "submissions accepted (memo + join + queued)",
            "memo_hits": "requests resolved from the result memo",
            "dedupe_joins": "requests joined to an in-flight digest",
            "keys_priced": "distinct digests priced (incl. degraded/errors)",
            "errors": "pricings that resolved to an exception",
            "coalesced_sweeps": "merged sweeps run for request groups",
            "coalesced_requests": "requests served out of merged sweeps",
            "rejected": "submissions bounced by queue backpressure",
            "degraded": "requests answered with the bound-only ranking",
            "cancelled": "queued requests dropped before any pricing",
            "memo_restored": "memo entries restored from the journal at "
                             "boot (warm restarts)",
        })
        # durable memo (DESIGN.md §15): entries journal as they memoize;
        # boot with restore_memo=True replays them, then the journal is
        # re-snapshotted so it holds exactly the live memo + header.  A
        # non-restoring boot leaves the journal's warmth intact for a
        # later --resume — it only truncates any torn tail so its own
        # appends land on the committed prefix, not behind garbage.
        self.memo_path = os.fspath(memo_path) if memo_path else None
        self._memo_journal = (durable.Journal(self.memo_path)
                              if self.memo_path else None)
        self.memo_restored = 0
        if self._memo_journal is not None:
            if restore_memo:
                self.memo_restored = self._restore_memo()
                self.snapshot_memo()
            else:
                payloads, _ = self._memo_journal.recover()
                if not payloads:        # fresh journal: header frame first
                    self.snapshot_memo()
        self._worker = threading.Thread(target=self._run,
                                        name="repro_torch-serve", daemon=True)
        self._worker.start()

    # ---- client side ---------------------------------------------------
    def submit(self, request: PriceRequest, digest: str | None = None, *,
               deadline_s: float | None = None) -> Future:
        """Queue one request; the future resolves to its ``PriceResult``.

        ``deadline_s`` (falling back to ``default_deadline_s``) bounds the
        wall time this request may spend queued + priced; past it, the
        future resolves to a ``degraded=True`` bound ranking.  Raises
        ``QueueFullError`` when the queue is at ``max_queue`` (memo hits
        and joins are exempt — they need no queue slot).
        """
        digest = digest or request_digest(request)
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        fut: Future = Future()
        with self._wake:
            if self._stop:
                raise RuntimeError("scheduler is shut down")
            memo = self._memo.get(digest)
            if memo is not None:
                self.counters["requests"] += 1
                self.counters["memo_hits"] += 1
                self._memo.move_to_end(digest)
                fut.set_result(memo.result)
                return fut
            pending = self._inflight.get(digest)
            if pending is not None:
                self.counters["requests"] += 1
                self.counters["dedupe_joins"] += 1
                pending.futures.append(fut)
                return fut
            if self.max_queue is not None and len(self._queue) >= self.max_queue:
                # rejected before being counted as a request: the counter
                # identity covers accepted work only
                self.counters["rejected"] += 1
                raise QueueFullError(
                    f"scheduler queue is full ({self.max_queue} pending); "
                    f"retry with backoff",
                    retry_after_s=0.05 * (len(self._queue) + 1))
            self.counters["requests"] += 1
            deadline = (time.monotonic() + deadline_s
                        if deadline_s is not None else None)
            pending = _Pending(digest, request, deadline)
            pending.futures.append(fut)
            self._inflight[digest] = pending
            self._queue.append(pending)
            self._wake.notify()
        return fut

    def price_now(self, request: PriceRequest,
                  digest: str | None = None) -> PriceResult:
        """Synchronous convenience: submit and wait."""
        return self.submit(request, digest).result()

    def cancel(self, fut: Future) -> bool:
        """Detach one waiter (its client went away).

        A queued request all of whose waiters cancelled is dropped without
        pricing (counted in ``cancelled``); a request already being priced
        completes and memoizes — the work is sunk either way, and the next
        identical ask becomes a memo hit.  Returns True if ``fut`` itself
        was cancelled.
        """
        with self._wake:
            for pending in list(self._inflight.values()):
                if fut in pending.futures:
                    pending.futures.remove(fut)
                    if not pending.futures and pending in self._queue:
                        self._queue.remove(pending)
                        self._inflight.pop(pending.digest, None)
                        self.counters["cancelled"] += 1
                    break
        return fut.cancel()

    def encoded(self, digest: str, result: PriceResult) -> str:
        """Wire text for one result, rendered once per memoized digest —
        warm responses skip both the sweep AND re-serialization."""
        with self._lock:
            memo = self._memo.get(digest)
            if memo is not None and memo.wire is not None:
                return memo.wire
        from .schema import dumps

        wire = dumps(result)
        with self._lock:
            memo = self._memo.get(digest)
            if memo is not None:
                memo.wire = wire
        return wire

    # ---- durable memo (DESIGN.md §15) -----------------------------------
    def _restore_memo(self) -> int:
        """Replay the memo journal: header frame validated (kind, journal
        version, wire schema version — any mismatch means a different
        daemon wrote it, so restore nothing), then one memo entry per
        committed frame, capped at ``memo_entries``.  Torn tails were
        already truncated/quarantined by the journal recovery."""
        with obs.span("durable.recover", cat="serve", path=self.memo_path):
            payloads, _ = self._memo_journal.recover()
            if not payloads:
                return 0
            try:
                hdr = json.loads(payloads[0])
                ok = (isinstance(hdr, dict)
                      and hdr.get("kind") == _MEMO_KIND
                      and hdr.get("version") == _MEMO_VERSION
                      and hdr.get("schema_version") == SCHEMA_VERSION)
            except Exception:
                ok = False
            if not ok:
                return 0
            restored = 0
            for raw in payloads[1:]:
                if len(self._memo) >= self.memo_entries:
                    break
                try:
                    digest, wire = json.loads(raw)
                    memo = _Memo(loads(wire))
                    memo.wire = wire
                except Exception:
                    continue
                self._memo[digest] = memo
                restored += 1
            self.counters["memo_restored"] += restored
            return restored

    def snapshot_memo(self) -> int:
        """Atomically rewrite the memo journal as header + the live memo —
        the versioned snapshot a graceful drain persists (also run at boot
        so the journal never carries stale or foreign frames forward).
        Returns the number of entries snapshotted."""
        if self._memo_journal is None:
            return 0
        with self._lock:
            items = list(self._memo.items())
        entries = []
        for digest, memo in items:
            try:
                wire = memo.wire or dumps(memo.result)
                entries.append(json.dumps([digest, wire],
                                          separators=(",", ":")).encode())
            except Exception:
                continue
        try:
            self._memo_journal.rewrite([_memo_header()] + entries)
        except OSError:
            return 0
        return len(entries)

    def stats(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["memo_entries"] = len(self._memo)
            out["inflight"] = len(self._inflight) + len(self._queue)
            # accepted digests not yet priced/cancelled — closes the live
            # counter identity: requests == memo_hits + dedupe_joins +
            # keys_priced + cancelled + pending at any instant (the lock
            # makes counters and the in-flight table one atomic snapshot)
            out["pending"] = len(self._inflight)
        out["engine_cache"] = self.engine.cache.stats()
        out["metrics"] = obs.metrics.snapshot()
        return out

    def shutdown(self, wait: bool = True,
                 timeout: float | None = None) -> bool:
        """Stop accepting work; drain what is queued, then exit the worker
        and persist the engine's invariant cache.  Returns False when the
        worker failed to drain within ``timeout`` (it is a daemon thread,
        so a stuck engine cannot wedge interpreter exit — but callers
        should surface the failure; ``PricingDaemon`` does)."""
        with self._wake:
            self._stop = True
            self._wake.notify_all()
        drained = True
        if wait:
            self._worker.join(timeout)
            drained = not self._worker.is_alive()
        self.engine.save_cache()
        # an empty-memo drain that restored nothing has nothing to
        # snapshot — rewriting would wipe warmth a later --resume wants
        if self._memo or self.memo_restored:
            self.snapshot_memo()
        return drained

    # ---- worker side ---------------------------------------------------
    def _run(self):
        while True:
            with self._wake:
                while not self._queue and not self._stop:
                    self._wake.wait()
                if not self._queue and self._stop:
                    return
                batch, self._queue = self._queue, []
            self._serve_batch(batch)

    def _serve_batch(self, batch):
        groups: dict = {}
        solo: list = []
        if self.coalesce and len(batch) > 1:
            for p in batch:
                # deadline requests stay solo: a merged sweep would couple
                # their degradation decision to unrelated requests.  Fully
                # cancelled pendings also stay solo (served as a no-op).
                key = (None if p.deadline is not None or not p.futures
                       else _coalesce_key(p.request))
                if key is None:
                    solo.append(p)
                else:
                    groups.setdefault(key, []).append(p)
            merged_groups = [g for g in groups.values() if len(g) > 1]
            solo.extend(p for g in groups.values() if len(g) == 1 for p in g)
        else:
            merged_groups, solo = [], list(batch)
        for group in merged_groups:
            self._serve_coalesced(group)
        for p in solo:
            self._serve_one(p)

    def _serve_one(self, pending):
        if not pending.futures:
            # every waiter cancelled after this pending left the queue in a
            # worker batch — drop it without engine work
            with self._lock:
                self._inflight.pop(pending.digest, None)
                self.counters["cancelled"] += 1
            return
        deadline = pending.deadline
        if deadline is not None and time.monotonic() >= deadline:
            self._serve_degraded(pending)
            return
        progress = None
        if deadline is not None:
            def progress(done, total):
                if time.monotonic() >= deadline:
                    raise DeadlineExceeded(
                        f"deadline passed at {done}/{total} configs")
        try:
            with obs.span("serve.price", "serve",
                          digest=pending.digest[:12]):
                result = price(pending.request, engine=self.engine,
                               progress=progress)
        except DeadlineExceeded:
            self._serve_degraded(pending)
        except BaseException as exc:
            self._resolve(pending, None, exc)
        else:
            self._resolve(pending, result, None)

    def _serve_degraded(self, pending):
        """Deadline blown: answer with the closed-form bound ranking,
        explicitly flagged, instead of timing out or going silent."""
        try:
            with obs.span("serve.degraded", "serve",
                          digest=pending.digest[:12]):
                result = price_bounds(pending.request, engine=self.engine)
        except BaseException as exc:
            self._resolve(pending, None, exc)
            return
        with self._lock:
            self.counters["degraded"] += 1
        # not memoized: the next undeadlined ask deserves the exact sweep
        self._resolve(pending, result, None, memoize=False)

    def _serve_coalesced(self, group):
        tmpl = group[0].request
        merged_request = PriceRequest(
            workloads=tuple(
                w for i, p in enumerate(group)
                for w in _prefixed(p.request, f"q{i}::").workloads),
            traced=tuple(
                t for i, p in enumerate(group)
                for t in _prefixed(p.request, f"q{i}::").traced),
            machines=tmpl.machines, gpu_configs=tmpl.gpu_configs,
            top_k=tmpl.top_k, strict=tmpl.strict,
            machine_axis=tmpl.machine_axis,
        )
        try:
            with obs.span("serve.coalesce", "serve", requests=len(group)):
                merged = price(merged_request, engine=self.engine)
        except BaseException as exc:
            for p in group:
                self._resolve(p, None, exc)
            return
        with self._lock:
            self.counters["coalesced_sweeps"] += 1
            self.counters["coalesced_requests"] += len(group)
        for i, p in enumerate(group):
            report = _split_report(merged.report, f"q{i}::")
            self._resolve(p, PriceResult(report=report), None)

    def _resolve(self, pending, result, exc, memoize: bool = True):
        # durable memo: render the wire text eagerly (outside the lock —
        # it costs a serialization) so the journal frame and the lazily
        # cached memo.wire are one and the same bytes
        wire = None
        if exc is None and memoize and self._memo_journal is not None:
            try:
                wire = dumps(result)
            except Exception:
                wire = None
        with self._lock:
            self._inflight.pop(pending.digest, None)
            self.counters["keys_priced"] += 1
            if exc is None:
                if memoize:
                    memo = _Memo(result)
                    memo.wire = wire
                    self._memo[pending.digest] = memo
                    while len(self._memo) > self.memo_entries:
                        self._memo.popitem(last=False)
            else:
                self.counters["errors"] += 1
            futures = list(pending.futures)
        if wire is not None:
            # the commit point for this digest's warm-restart durability;
            # a failed append only costs warmth, never correctness
            try:
                self._memo_journal.append(
                    json.dumps([pending.digest, wire],
                               separators=(",", ":")).encode())
            except OSError:
                pass
        for fut in futures:
            if fut.cancelled():
                continue
            try:
                if exc is None:
                    fut.set_result(result)
                else:
                    fut.set_exception(exc)
            except Exception:  # noqa: BLE001 — racing client cancellation
                pass


__all__ = ["Scheduler", "QueueFullError", "DeadlineExceeded"]
