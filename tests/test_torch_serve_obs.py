"""The port's daemon observability over the wire (DESIGN.md §14): the
``stats`` op's live counter identity under a request storm, the codec
round-trip of the stats payload, and the ``trace`` op shipping the daemon's
span timeline — ``tests/test_serve_obs.py`` run on ``repro_torch.serve``.
"""
import json
import os
import threading
import time

import pytest

from repro_torch import obs
from repro_torch.api import gpu_request
from repro_torch.core.access import LaunchConfig
from repro_torch.core.engine import Explorer
from repro_torch.core.machines import GPUMachine
from repro_torch.core.specs import star_stencil_3d
from repro_torch.serve import PriceClient, PricingDaemon
from repro_torch.serve.daemon import can_bind_unix_sockets

SMALL = GPUMachine(
    name="A100/8", n_sms=13, clock_hz=1.41e9, l1_bytes=192 * 1024,
    l2_bytes=20 * 1024 * 1024 // 8, dram_bw=1400e9 / 8, l2_bw=5000e9 / 8,
    peak_flops_dp=9.7e12 / 8,
)
CONFIGS = [LaunchConfig(block=b) for b in [(64, 4, 2), (32, 4, 4), (8, 8, 8)]]
DOMAINS = [(16, 24, 32), (24, 24, 32), (16, 32, 32)]

needs_sockets = pytest.mark.skipif(
    not can_bind_unix_sockets(os.environ.get("TMPDIR", "/tmp")),
    reason="environment cannot bind Unix sockets")


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _request(domain):
    return gpu_request(star_stencil_3d(r=1, domain=domain), SMALL, CONFIGS)


def _assert_identity(stats):
    assert stats["requests"] == (
        stats["memo_hits"] + stats["dedupe_joins"] + stats["keys_priced"]
        + stats["cancelled"] + stats["pending"]), stats


@needs_sockets
def test_stats_identity_holds_live_under_request_storm(tmp_path):
    """``requests == memo_hits + dedupe_joins + keys_priced + cancelled +
    pending`` in EVERY live snapshot a concurrent poller takes mid-storm,
    not just after the queue drains."""
    sock = str(tmp_path / "serve.sock")
    n_threads, per_thread = 4, 6
    samples, errors = [], []
    stop = threading.Event()
    with PricingDaemon(sock, engine=Explorer(parallel=False)):

        def poll():
            try:
                with PriceClient(sock, timeout=120) as c:
                    while not stop.is_set():
                        samples.append(c.stats())
                        time.sleep(0.002)
            except BaseException as exc:
                errors.append(exc)

        def storm(i):
            try:
                with PriceClient(sock, timeout=120) as c:
                    for j in range(per_thread):
                        # repeats across threads exercise memo hits and
                        # in-flight joins while the poller watches
                        c.price(_request(DOMAINS[(i + j) % len(DOMAINS)]))
            except BaseException as exc:
                errors.append(exc)

        poller = threading.Thread(target=poll)
        poller.start()
        threads = [threading.Thread(target=storm, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        stop.set()
        poller.join(120)
        with PriceClient(sock, timeout=120) as c:
            final = c.stats()
    assert not errors
    assert samples, "poller must have sampled mid-storm"
    for s in samples + [final]:
        _assert_identity(s)
    assert final["requests"] == n_threads * per_thread
    assert final["pending"] == 0
    assert final["keys_priced"] == len(DOMAINS)    # one sweep per digest
    assert final["memo_hits"] + final["dedupe_joins"] == \
        n_threads * per_thread - len(DOMAINS)
    # the canonical metrics snapshot rides along and agrees
    assert final["metrics"]["serve.requests"] == final["requests"]
    assert final["metrics"]["serve.keys_priced"] == final["keys_priced"]


@needs_sockets
def test_stats_payload_round_trips_through_the_codec(tmp_path):
    from repro_torch.serve.schema import decode, encode

    sock = str(tmp_path / "serve.sock")
    with PricingDaemon(sock, engine=Explorer(parallel=False)):
        with PriceClient(sock, timeout=120) as c:
            c.price(_request(DOMAINS[0]))
            stats = c.stats()
    _assert_identity(stats)
    assert decode(encode(stats)) == stats
    # and it is plain JSON already (the wire format is newline-JSON)
    assert json.loads(json.dumps(stats)) == stats


@needs_sockets
def test_trace_op_ships_the_daemon_span_timeline(tmp_path):
    sock = str(tmp_path / "serve.sock")
    req = _request(DOMAINS[0])
    with PricingDaemon(sock, engine=Explorer(parallel=False)):
        with PriceClient(sock, timeout=120) as c:
            # telemetry off: the op answers honestly with an empty timeline
            empty = c.trace()
            assert empty["traceEvents"] == []

            obs.enable()           # daemon shares this process's collector
            c.price(req)           # cold: full pipeline under spans
            c.price(req)           # warm: memo hit, dispatch span only
            trace = c.trace()
    assert json.loads(json.dumps(trace)) == trace
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    names = {e["name"] for e in xs}
    assert {"daemon.op", "serve.price", "engine.sweep",
            "engine.rank"} <= names
    price_ops = [e for e in xs
                 if e["name"] == "daemon.op" and e["args"]["op"] == "price"]
    assert len(price_ops) == 2     # cold and warm both traced
    # the sweep nests (transitively) under the scheduler's serve.price
    by_id = {e["args"]["span_id"]: e for e in xs}
    sweep = next(e for e in xs if e["name"] == "engine.sweep")
    seen, cur = set(), sweep
    while cur.get("args", {}).get("parent_id") in by_id:
        cur = by_id[cur["args"]["parent_id"]]
        seen.add(cur["name"])
        if len(seen) > len(xs):
            break
    assert "serve.price" in seen


# ========================================================================
# the frozen cache_stats schema of a served (coalesced) report
# (tests/test_cache_stats_schema.py)
# ========================================================================
#: every full (non-degraded) sweep emits exactly these
BASE_KEYS = frozenset({
    "hits", "misses", "entries", "evictions", "pool_tasks", "bound_evals",
    "cells", "shared_cells", "evaluated", "pruned",
    "streams_built", "streams_shared", "waves_folded", "wave_fallbacks",
})


def test_coalesced_split_reports_add_exactly_the_coalesced_key():
    from concurrent.futures import Future

    from repro_torch.obs.metrics import CACHE_STATS_KEYS
    from repro_torch.serve.scheduler import Scheduler, _Pending
    from repro_torch.serve.schema import request_digest

    assert BASE_KEYS | {"coalesced"} <= set(CACHE_STATS_KEYS)
    sched = Scheduler(Explorer(parallel=False))
    try:
        reqs = [_request(d) for d in DOMAINS[:2]]
        pendings, futs = [], []
        for r in reqs:
            digest = request_digest(r)
            p = _Pending(digest, r)
            fut = Future()
            p.futures.append(fut)
            with sched._lock:
                sched._inflight[digest] = p
            pendings.append(p)
            futs.append(fut)
        sched._serve_coalesced(pendings)
        for fut in futs:
            rep = fut.result(120).report
            assert rep.cache_stats["coalesced"] is True
            assert set(rep.cache_stats) == BASE_KEYS | {"coalesced"}
            assert rep.metrics["serve.coalesced"] == 1
    finally:
        sched.shutdown()
