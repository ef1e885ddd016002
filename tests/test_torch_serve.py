"""The port's pricing service (``repro_torch.serve``, DESIGN.md §12):
scheduler dedupe/memo/coalescing accounting, and the daemon + client over a
real Unix socket — ``tests/test_serve.py`` run on the port, every client
with a timeout.  Then what only the port has: a request that ``price``
refuses (``traced``) fails alone beside compatible requests, a served answer
equals ``repro.api.price``'s on the wire, and ``python -m repro_torch.serve``
starts nothing on import.

Determinism pattern for in-flight assertions: gate the scheduler worker's
``price`` call on an event (``_gated_scheduler``) so the requests under
test are guaranteed to land while the gated one is in flight — join and
coalesce counters become exact, never timing-dependent, no matter how
loaded the test runner is.
"""
import dataclasses
import os
import threading
import time

import pytest

from repro_torch.api import PriceRequest, gpu_request, price
from repro_torch.core.access import LaunchConfig
from repro_torch.core.engine import Explorer, Workload
from repro_torch.core.machines import GPUMachine
from repro_torch.core.specs import star_stencil_3d
from repro_torch.serve import PriceClient, PricingDaemon, Scheduler, ServeError
from repro_torch.serve.daemon import can_bind_unix_sockets
from repro_torch.serve.schema import request_digest

SMALL = GPUMachine(
    name="A100/8", n_sms=13, clock_hz=1.41e9, l1_bytes=192 * 1024,
    l2_bytes=20 * 1024 * 1024 // 8, dram_bw=1400e9 / 8, l2_bw=5000e9 / 8,
    peak_flops_dp=9.7e12 / 8,
)
CONFIGS = [LaunchConfig(block=b) for b in [(64, 4, 2), (32, 4, 4), (8, 8, 8)]]


def quick_request(r=1, domain=(16, 24, 32)):
    return gpu_request(star_stencil_3d(r=r, domain=domain), SMALL, CONFIGS)


def slow_request():
    """A sweep big enough to keep the worker busy while others queue."""
    from repro_torch.core.selector import enumerate_gpu_configs

    return gpu_request(star_stencil_3d(r=3, domain=(32, 32, 64)), SMALL,
                       enumerate_gpu_configs(512))


def _entry_key(e):
    return (e.workload, e.machine, e.backend, e.index, e.config,
            e.estimate, e.perf, e.limiter)


needs_sockets = pytest.mark.skipif(
    not can_bind_unix_sockets(os.environ.get("TMPDIR", "/tmp")),
    reason="environment cannot bind Unix sockets")


def _gated_scheduler(monkeypatch, gate_names=("gate",)):
    """A scheduler whose worker blocks pricing any workload in
    ``gate_names`` until ``release`` is set — requests submitted in the
    meantime are provably in flight / queued, whatever the host load."""
    import repro_torch.serve.scheduler as sched_mod

    real_price = sched_mod.price
    release = threading.Event()

    def gated_price(request, **kw):
        if any(w.name in gate_names for w in request.workloads):
            assert release.wait(120), "test gate never released"
        return real_price(request, **kw)

    monkeypatch.setattr(sched_mod, "price", gated_price)
    return Scheduler(Explorer(parallel=False)), release


# ========================================================================
# scheduler
# ========================================================================
def test_identical_inflight_requests_join_once(monkeypatch):
    spec = star_stencil_3d(r=1, domain=(16, 24, 32))
    req = PriceRequest(
        workloads=[Workload(name="gate", gpu_spec=spec, gpu_configs=CONFIGS)],
        machines=[SMALL])
    sched, release = _gated_scheduler(monkeypatch)
    try:
        # the first submission cannot resolve until release -> the other
        # four are guaranteed to find its digest in flight and join it
        futs = [sched.submit(req) for _ in range(5)]
        release.set()
        results = [f.result(120) for f in futs]
        c = sched.counters
        assert c["keys_priced"] == 1               # one price for all five
        assert c["dedupe_joins"] == 4
        assert c["requests"] == 5
        assert c["requests"] == (c["memo_hits"] + c["dedupe_joins"]
                                 + c["keys_priced"])
        first = [_entry_key(e) for e in results[0].entries]
        assert all([_entry_key(e) for e in r.entries] == first
                   for r in results[1:])
    finally:
        sched.shutdown()


def test_memoized_digest_resolves_without_engine_work():
    sched = Scheduler(Explorer(parallel=False))
    try:
        req = quick_request()
        cold = sched.price_now(req)
        warm = sched.price_now(req)
        c = sched.counters
        assert c["keys_priced"] == 1 and c["memo_hits"] == 1
        assert [_entry_key(e) for e in warm.entries] == \
            [_entry_key(e) for e in cold.entries]
    finally:
        sched.shutdown()


def test_queued_compatible_requests_coalesce_into_one_sweep(monkeypatch):
    sched, release = _gated_scheduler(monkeypatch)
    try:
        spec = star_stencil_3d(r=2, domain=(20, 28, 36))
        blocker = sched.submit(PriceRequest(
            workloads=[Workload(name="gate", gpu_spec=spec,
                                gpu_configs=CONFIGS)],
            machines=[SMALL]))
        # wait until the worker has dequeued the blocker (queue empty, the
        # pending still in flight): everything submitted from here on
        # queues behind the gated batch and gets grabbed as ONE batch
        t0 = time.monotonic()
        while sched.stats()["inflight"] > 1:
            assert time.monotonic() - t0 < 120
            time.sleep(0.01)
        reqs = [quick_request(r=1, domain=d)
                for d in [(16, 24, 32), (24, 24, 32), (16, 32, 32),
                          (24, 32, 32)]]
        futs = [sched.submit(r) for r in reqs]
        release.set()
        results = [f.result(120) for f in futs]
        blocker.result(120)
        c = sched.counters
        assert c["coalesced_sweeps"] == 1
        assert c["coalesced_requests"] == 4
        assert c["keys_priced"] == 5
        # split results are bitwise identical to solo sweeps — workload
        # names are labels, never pricing inputs
        for req, res in zip(reqs, results):
            solo = price(req, engine=Explorer(parallel=False))
            assert [_entry_key(e) for e in res.entries] == \
                [_entry_key(e) for e in solo.entries]
            assert res.cache_stats.get("coalesced") is True
    finally:
        sched.shutdown()


def test_plan_requests_never_coalesce():
    from repro_torch.serve.scheduler import _coalesce_key

    assert _coalesce_key(quick_request()) is not None
    assert _coalesce_key(PriceRequest(
        plans={"w": None}, machines=["TPUv5e"])) is None


def test_memo_is_bounded_lru():
    sched = Scheduler(Explorer(parallel=False), memo_entries=2)
    try:
        reqs = [quick_request(r=1, domain=d)
                for d in [(16, 24, 32), (24, 24, 32), (16, 32, 32)]]
        for r in reqs:
            sched.price_now(r)
        assert sched.stats()["memo_entries"] == 2
        sched.price_now(reqs[0])                   # evicted -> priced again
        assert sched.counters["keys_priced"] == 4
        sched.price_now(reqs[2])                   # still memoized
        assert sched.counters["memo_hits"] == 1
    finally:
        sched.shutdown()


def test_failing_request_propagates_and_counts():
    sched = Scheduler(Explorer(parallel=False))
    try:
        bad = PriceRequest(workloads=[Workload(name="w")],
                           machines=["no-such-machine"])
        with pytest.raises(KeyError, match="unknown machine"):
            sched.price_now(bad)
        ok = sched.price_now(quick_request())      # scheduler survives
        assert ok.entries
        assert sched.counters["errors"] == 1
    finally:
        sched.shutdown()


def test_shutdown_rejects_new_work_and_persists_cache(tmp_path):
    cache = tmp_path / "sched.invcache"
    sched = Scheduler(Explorer(parallel=False, cache_path=str(cache)))
    sched.price_now(quick_request())
    sched.shutdown()
    assert cache.exists()
    assert Explorer(cache_path=str(cache)).cache.loaded_entries > 0
    with pytest.raises(RuntimeError, match="shut down"):
        sched.submit(quick_request())


# ========================================================================
# daemon + client over a real socket
# ========================================================================
@needs_sockets
def test_daemon_concurrent_identical_clients_price_once(tmp_path):
    sock = str(tmp_path / "serve.sock")
    with PricingDaemon(sock, engine=Explorer(parallel=False)):
        with PriceClient(sock, timeout=120) as warmup:
            assert warmup.ping()
            warmup.price(slow_request())           # worker knowledge: warm

        req = quick_request(r=2, domain=(20, 28, 36))
        results, errors = [None] * 4, []
        barrier = threading.Barrier(4)

        def hit(i):
            try:
                with PriceClient(sock, timeout=120) as c:
                    barrier.wait()
                    results[i] = c.price(req)
            except BaseException as exc:
                errors.append(exc)

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not errors
        with PriceClient(sock, timeout=120) as c:
            stats = c.stats()
        # 4 identical concurrent requests -> exactly one new key priced
        assert stats["keys_priced"] == 2           # slow warmup + req
        assert stats["memo_hits"] + stats["dedupe_joins"] == 3
        first = [_entry_key(e) for e in results[0].entries]
        assert all([_entry_key(e) for e in r.entries] == first
                   for r in results[1:])


@needs_sockets
def test_daemon_pipelined_batch_streams_and_dedupes(tmp_path):
    sock = str(tmp_path / "serve.sock")
    with PricingDaemon(sock, engine=Explorer(parallel=False)):
        req_a, req_b = quick_request(), quick_request(r=2, domain=(20, 28, 36))
        order = []
        with PriceClient(sock, timeout=120) as c:
            c.price(req_a)                         # prime the memo
            results = c.price_many(
                [slow_request(), req_a, req_b, req_b],
                on_result=lambda i, r: order.append(i))
            stats = c.stats()
        assert len(results) == 4
        assert [_entry_key(e) for e in results[2].entries] == \
            [_entry_key(e) for e in results[3].entries]
        assert stats["requests"] == 5
        assert stats["memo_hits"] == 1             # req_a resubmitted warm
        assert stats["dedupe_joins"] == 1          # second req_b joined
        assert stats["keys_priced"] == 3           # req_a, slow, req_b
        # completion-order streaming: the warm answer for request 1 must
        # arrive ahead of the slow cold sweep pipelined in front of it
        assert order[0] == 1 and set(order) == {0, 1, 2, 3}
        assert order.index(0) < order.index(2)     # worker runs in order


@needs_sockets
def test_daemon_warm_restart_reloads_cache(tmp_path):
    sock = str(tmp_path / "serve.sock")
    cache = str(tmp_path / "daemon.invcache")
    req = quick_request()
    with PricingDaemon(sock, engine=Explorer(parallel=False,
                                             cache_path=cache)):
        with PriceClient(sock, timeout=120) as c:
            cold = c.price(req)
    assert os.path.exists(cache)
    with PricingDaemon(sock, engine=Explorer(parallel=False,
                                             cache_path=cache)) as daemon:
        assert daemon.scheduler.engine.cache.loaded_entries > 0
        with PriceClient(sock, timeout=120) as c:
            warm = c.price(req)
            stats = c.stats()
        # fresh memo, warm invariant cache: priced again but all cache hits
        assert stats["keys_priced"] == 1
        assert stats["engine_cache"]["misses"] == 0
    assert [_entry_key(e) for e in warm.entries] == \
        [_entry_key(e) for e in cold.entries]


@needs_sockets
def test_daemon_bad_request_yields_error_not_hang(tmp_path):
    sock = str(tmp_path / "serve.sock")
    with PricingDaemon(sock, engine=Explorer(parallel=False)):
        with PriceClient(sock, timeout=120) as c:
            bad = dataclasses.replace(quick_request(), version=99)
            with pytest.raises(ServeError, match="version"):
                c.price(bad)
            assert c.ping()                        # connection still usable
            assert c.price(quick_request()).entries


@needs_sockets
def test_daemon_result_is_bitwise_in_process_result(tmp_path):
    sock = str(tmp_path / "serve.sock")
    req = quick_request(r=2, domain=(24, 32, 64))
    local = price(req, engine=Explorer(parallel=False))
    with PricingDaemon(sock, engine=Explorer(parallel=False)):
        with PriceClient(sock, timeout=120) as c:
            remote = c.price(req)
    assert [_entry_key(e) for e in remote.entries] == \
        [_entry_key(e) for e in local.entries]
    # the digest is stable across the round trip the daemon performed
    from repro_torch.serve.schema import decode, encode

    assert request_digest(decode(encode(req))) == request_digest(req)


# ========================================================================
# what only the port has
# ========================================================================
def test_refused_request_fails_alone_beside_compatible_ones(monkeypatch):
    """The port's ``price`` refuses a request that fills ``traced``; queued
    beside compatible requests it is served solo (``_coalesce_key`` None),
    so it fails with the reference's error class and theirs coalesce into
    the answers they get alone."""
    from repro_torch.serve.scheduler import _coalesce_key

    refused = dataclasses.replace(quick_request(), traced=(Workload(name="t"),))
    assert _coalesce_key(refused) is None
    sched, release = _gated_scheduler(monkeypatch)
    try:
        blocker = sched.submit(PriceRequest(
            workloads=[Workload(name="gate",
                                gpu_spec=star_stencil_3d(r=1, domain=(16, 24, 32)),
                                gpu_configs=CONFIGS)],
            machines=[SMALL]))
        t0 = time.monotonic()
        while sched.stats()["inflight"] > 1:
            assert time.monotonic() - t0 < 120
            time.sleep(0.01)
        reqs = [quick_request(r=1, domain=d)
                for d in [(16, 24, 32), (24, 24, 32), (16, 32, 32)]]
        futs = [sched.submit(r) for r in reqs[:2]]
        bad = sched.submit(refused)
        futs.append(sched.submit(reqs[2]))
        release.set()
        with pytest.raises(ValueError, match="traced"):
            bad.result(120)
        results = [f.result(120) for f in futs]
        blocker.result(120)
        c = sched.counters
        assert c["coalesced_sweeps"] == 1 and c["coalesced_requests"] == 3
        assert c["errors"] == 1 and c["keys_priced"] == 5
        for req, res in zip(reqs, results):
            solo = price(req, engine=Explorer(parallel=False))
            assert [_entry_key(e) for e in res.entries] == \
                [_entry_key(e) for e in solo.entries]
    finally:
        release.set()
        sched.shutdown()


@needs_sockets
def test_daemon_answers_an_undecodable_request_with_an_error_line(tmp_path):
    """A reference request with a traced kernel carries a tag the port's
    codec does not have: the daemon answers with an error line naming it,
    and the connection stays usable."""
    from repro_torch.serve.schema import encode

    wire = encode(quick_request())
    wire["f"]["traced"] = {"$": "tuple", "v": [{"$": "TracedSpecPayload",
                                                "f": {"name": "t"}}]}
    sock = str(tmp_path / "serve.sock")
    with PricingDaemon(sock, engine=Explorer(parallel=False)):
        with PriceClient(sock, timeout=120) as c:
            c._send({"op": "price", "id": 7, "request": wire})
            msg = c._recv()
            assert msg["ok"] is False and msg["id"] == 7
            assert msg["error_class"] == "TypeError"
            assert "TracedSpecPayload" in msg["error"]
            assert c.ping()
            assert c.price(quick_request()).entries


def test_main_module_does_not_run_on_import(tmp_path):
    """Importing ``repro_torch.serve.__main__`` (as a walk over the package
    does) starts no daemon and binds no socket; ``python -m`` runs it."""
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src, TMPDIR=str(tmp_path))
    code = ("import repro_torch.serve.__main__ as m, repro_torch.serve.daemon as d; "
            "print(m.main is d.main, d.DEFAULT_SOCKET)")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    same, default = proc.stdout.split()
    assert same == "True" and default == str(tmp_path / "repro_torch-serve.sock")
    assert os.listdir(tmp_path) == []
    proc = subprocess.run([sys.executable, "-m", "repro_torch.serve", "--help"], env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("usage: python -m repro_torch.serve")
    assert "--resume" in proc.stdout and "--pid-file" in proc.stdout
    assert os.listdir(tmp_path) == []
