"""Failure model of the port's pricing service (DESIGN.md §13): deadlines
that degrade instead of hanging, bounded-queue backpressure, cancellation of
abandoned work, error-class propagation over the wire, client retry
idempotence, and honest shutdown — ``tests/test_serve_faults.py`` run on
``repro_torch.serve``, every client with a timeout.

Reuses the gating pattern from test_serve.py: the scheduler worker blocks
pricing the "gate" workload until released, so queue/backpressure/cancel
assertions are exact rather than timing-dependent.
"""
import os
import threading
import time

import pytest

from repro_torch import faults
from repro_torch.api import PriceRequest, gpu_request, price
from repro_torch.core.access import LaunchConfig
from repro_torch.core.engine import Explorer, Workload
from repro_torch.core.machines import GPUMachine
from repro_torch.core.specs import star_stencil_3d
from repro_torch.serve import (
    PriceClient,
    PricingDaemon,
    QueueFullError,
    Scheduler,
    ServeError,
)
from repro_torch.serve.daemon import can_bind_unix_sockets
from repro_torch.serve.schema import encode

SMALL = GPUMachine(
    name="A100/8", n_sms=13, clock_hz=1.41e9, l1_bytes=192 * 1024,
    l2_bytes=20 * 1024 * 1024 // 8, dram_bw=1400e9 / 8, l2_bw=5000e9 / 8,
    peak_flops_dp=9.7e12 / 8,
)
CONFIGS = [LaunchConfig(block=b) for b in [(64, 4, 2), (32, 4, 4), (8, 8, 8)]]

needs_sockets = pytest.mark.skipif(
    not can_bind_unix_sockets(os.environ.get("TMPDIR", "/tmp")),
    reason="environment cannot bind Unix sockets")


def quick_request(r=1, domain=(16, 24, 32)):
    return gpu_request(star_stencil_3d(r=r, domain=domain), SMALL, CONFIGS)


def slow_request():
    from repro_torch.core.selector import enumerate_gpu_configs

    return gpu_request(star_stencil_3d(r=3, domain=(32, 32, 64)), SMALL,
                       enumerate_gpu_configs(512))


def gate_request():
    return PriceRequest(
        workloads=[Workload(name="gate",
                            gpu_spec=star_stencil_3d(r=1, domain=(16, 24, 32)),
                            gpu_configs=CONFIGS)],
        machines=[SMALL])


def _gated(monkeypatch, **sched_kw):
    """Scheduler whose worker blocks on the "gate" workload until released;
    ``started`` proves the gate is in flight (queue slot freed)."""
    import repro_torch.serve.scheduler as sched_mod

    real_price = sched_mod.price
    release, started = threading.Event(), threading.Event()

    def gated_price(request, **kw):
        if any(w.name == "gate" for w in request.workloads):
            started.set()
            assert release.wait(120), "test gate never released"
        return real_price(request, **kw)

    monkeypatch.setattr(sched_mod, "price", gated_price)
    return (Scheduler(Explorer(parallel=False), **sched_kw),
            release, started)


def _identity(c):
    return c["requests"] == (c["memo_hits"] + c["dedupe_joins"]
                             + c["keys_priced"] + c["cancelled"])


# ========================================================================
# scheduler: deadlines and graceful degradation
# ========================================================================
def test_expired_deadline_resolves_degraded_never_memoized():
    sched = Scheduler(Explorer(parallel=False))
    try:
        req = quick_request()
        degraded = sched.submit(req, deadline_s=0.0).result(120)
        assert degraded.degraded
        assert degraded.entries, "degraded answer must still rank configs"
        assert all(e.limiter == "bound" for e in degraded.entries)
        assert all(e.estimate is None for e in degraded.entries)
        assert degraded.cache_stats.get("degraded") is True
        c = sched.counters
        assert c["degraded"] == 1 and c["keys_priced"] == 1
        assert _identity(c)

        # never memoized: the next undeadlined ask runs the exact sweep...
        exact = sched.submit(req).result(120)
        assert not exact.degraded
        assert sched.counters["memo_hits"] == 0
        assert sched.counters["keys_priced"] == 2
        # ...and THAT one memoizes as usual
        warm = sched.submit(req).result(120)
        assert not warm.degraded
        assert sched.counters["memo_hits"] == 1

        # the bound ranking is sound w.r.t. the exact one: same config set
        assert ({e.index for e in degraded.entries}
                == {e.index for e in exact.entries})
    finally:
        sched.shutdown()


def test_mid_sweep_deadline_abandons_exact_sweep():
    sched = Scheduler(Explorer(parallel=False))
    try:
        t0 = time.monotonic()
        result = sched.submit(slow_request(), deadline_s=0.3).result(120)
        elapsed = time.monotonic() - t0
        assert result.degraded
        assert result.entries
        assert sched.counters["degraded"] == 1
        # the whole point: far faster than the exact sweep it abandoned
        assert elapsed < 60
    finally:
        sched.shutdown()


def test_default_deadline_applies_to_every_request():
    sched = Scheduler(Explorer(parallel=False), default_deadline_s=0.0)
    try:
        result = sched.submit(quick_request()).result(120)
        assert result.degraded
        # an explicit generous deadline overrides the default
        exact = sched.submit(quick_request(), deadline_s=600.0).result(120)
        assert not exact.degraded
    finally:
        sched.shutdown()


# ========================================================================
# scheduler: bounded queue and cancellation
# ========================================================================
def test_queue_full_rejects_with_retry_hint(monkeypatch):
    sched, release, started = _gated(monkeypatch, max_queue=1)
    try:
        gate_fut = sched.submit(gate_request())
        assert started.wait(120)            # gate in flight, queue empty
        fut_a = sched.submit(quick_request(domain=(16, 24, 40)))
        with pytest.raises(QueueFullError) as exc_info:
            sched.submit(quick_request(domain=(16, 24, 48)))
        assert exc_info.value.retry_after_s > 0
        c = sched.counters
        assert c["rejected"] == 1
        assert c["requests"] == 2           # rejected was never accepted
        # joins and memo hits need no queue slot: never rejected
        join_fut = sched.submit(quick_request(domain=(16, 24, 40)))
        assert sched.counters["dedupe_joins"] == 1
        release.set()
        for fut in (gate_fut, fut_a, join_fut):
            assert fut.result(120) is not None
        assert _identity(sched.counters)
    finally:
        release.set()
        sched.shutdown()


def test_cancel_queued_request_skips_engine_work(monkeypatch):
    sched, release, started = _gated(monkeypatch)
    try:
        gate_fut = sched.submit(gate_request())
        assert started.wait(120)
        doomed = sched.submit(quick_request(domain=(16, 24, 40)))
        assert sched.cancel(doomed) is True
        assert doomed.cancelled()
        release.set()
        gate_fut.result(120)
        c = sched.counters
        assert c["cancelled"] == 1
        assert c["keys_priced"] == 1        # only the gate was ever priced
        assert c["requests"] == 2
        assert _identity(c)
    finally:
        release.set()
        sched.shutdown()


def test_cancel_one_waiter_keeps_joined_waiter_alive(monkeypatch):
    sched, release, started = _gated(monkeypatch)
    try:
        gate_fut = sched.submit(gate_request())
        assert started.wait(120)
        req = quick_request(domain=(16, 24, 40))
        fut_a = sched.submit(req)
        fut_b = sched.submit(req)           # joins fut_a's pending
        assert sched.cancel(fut_a) is True
        release.set()
        result = fut_b.result(120)          # survivor still gets the answer
        assert result.entries
        gate_fut.result(120)
        c = sched.counters
        assert c["cancelled"] == 0          # the pending itself survived
        assert c["keys_priced"] == 2
        assert _identity(c)
    finally:
        release.set()
        sched.shutdown()


def test_shutdown_reports_undrained_worker(monkeypatch):
    import repro_torch.serve.scheduler as sched_mod

    release = threading.Event()
    monkeypatch.setattr(sched_mod, "price",
                        lambda request, **kw: release.wait(120))
    sched = Scheduler(Explorer(parallel=False))
    sched.submit(quick_request())
    time.sleep(0.05)                        # let the worker enter price()
    assert sched.shutdown(wait=True, timeout=0.2) is False
    release.set()                           # unwedge the daemon thread


# ========================================================================
# daemon + client over a real socket
# ========================================================================
@needs_sockets
def test_error_class_travels_the_wire(tmp_path):
    sock = str(tmp_path / "serve.sock")
    bad = gpu_request(star_stencil_3d(r=1, domain=(16, 24, 32)),
                      "NoSuchMachine", CONFIGS)
    with PricingDaemon(sock, engine=Explorer(parallel=False)) as _d:
        with PriceClient(sock, timeout=120) as client:
            with pytest.raises(ServeError) as exc_info:
                client.price(bad)
            assert exc_info.value.error_class == "KeyError"
            assert not exc_info.value.retryable


@needs_sockets
def test_client_connect_failure_leaks_no_fd(tmp_path):
    fd_dir = "/proc/self/fd"
    if not os.path.isdir(fd_dir):
        pytest.skip("needs /proc")
    missing = str(tmp_path / "nobody-listens.sock")
    before = len(os.listdir(fd_dir))
    for _ in range(5):
        with pytest.raises(OSError):
            PriceClient(missing, timeout=10)
    assert len(os.listdir(fd_dir)) == before


@needs_sockets
def test_client_close_is_idempotent_and_guards_use(tmp_path):
    sock = str(tmp_path / "serve.sock")
    with PricingDaemon(sock, engine=Explorer(parallel=False)) as _d:
        client = PriceClient(sock, timeout=120)
        assert client.ping()
        client.close()
        client.close()                      # double close must be a no-op
        with pytest.raises(OSError, match="closed"):
            client.price(quick_request())


@needs_sockets
def test_socket_drop_recovered_by_idempotent_retry(tmp_path):
    """The daemon severs the connection mid-response; a retrying client
    reconnects and resubmits — the digest makes the resubmission a memo
    hit, and on_result fires exactly once despite two attempts."""
    sock = str(tmp_path / "serve.sock")
    req = quick_request()
    expected = price(req)
    deliveries = []
    with PricingDaemon(sock, engine=Explorer(parallel=False)) as daemon:
        with faults.injected(faults.FaultPlan(seed=21, faults={
                "serve.socket_drop": faults.FaultSpec(at=(0,))})):
            with PriceClient(sock, retries=3, backoff_s=0.01,
                             timeout=60) as client:
                out = client.price_many(
                    [req], on_result=lambda i, r: deliveries.append(i))
        assert deliveries == [0]
        assert [e.perf for e in out[0].entries] == \
            [e.perf for e in expected.entries]
        stats = daemon.scheduler.stats()
        assert stats["requests"] >= 2       # original + resubmission
        assert stats["memo_hits"] >= 1      # retry cost no second sweep
        assert stats["keys_priced"] == 1


@needs_sockets
def test_no_retry_client_surfaces_the_drop(tmp_path):
    sock = str(tmp_path / "serve.sock")
    with PricingDaemon(sock, engine=Explorer(parallel=False)) as _d:
        with faults.injected(faults.FaultPlan(seed=21, faults={
                "serve.socket_drop": faults.FaultSpec(at=(0,))})):
            with PriceClient(sock, timeout=60) as client:
                with pytest.raises(ServeError) as exc_info:
                    client.price(quick_request())
            assert exc_info.value.error_class == "ConnectionClosed"
            assert exc_info.value.retryable


@needs_sockets
def test_backpressure_retry_succeeds_after_drain(tmp_path, monkeypatch):
    sock = str(tmp_path / "serve.sock")
    sched, release, started = _gated(monkeypatch, max_queue=1)
    with PricingDaemon(sock, scheduler=sched) as daemon:
        gate_fut = daemon.scheduler.submit(gate_request())
        assert started.wait(120)
        daemon.scheduler.submit(quick_request(domain=(16, 24, 40)))
        threading.Timer(0.2, release.set).start()
        with PriceClient(sock, retries=6, backoff_s=0.05,
                         timeout=60) as client:
            result = client.price(quick_request(domain=(16, 24, 48)))
        assert result.entries
        gate_fut.result(120)
        assert daemon.scheduler.counters["rejected"] >= 1
        assert _identity(daemon.scheduler.counters)


@needs_sockets
def test_abandoned_connection_cancels_queued_work(tmp_path, monkeypatch):
    sock = str(tmp_path / "serve.sock")
    sched, release, started = _gated(monkeypatch)
    with PricingDaemon(sock, scheduler=sched) as daemon:
        gate_fut = daemon.scheduler.submit(gate_request())
        assert started.wait(120)
        quitter = PriceClient(sock, timeout=120)
        quitter._send({"op": "price", "id": 1,
                       "request": encode(quick_request(domain=(16, 24, 40)))})
        deadline = time.monotonic() + 120
        while (daemon.scheduler.counters["requests"] < 2
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert daemon.scheduler.counters["requests"] == 2
        quitter.close()                     # abandon without reading
        while (daemon.scheduler.counters["cancelled"] < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
        release.set()
        gate_fut.result(120)
        c = daemon.scheduler.counters
        assert c["cancelled"] == 1
        assert c["keys_priced"] == 1        # abandoned sweep never ran
        assert _identity(c)


@needs_sockets
def test_daemon_exit_raises_on_stuck_serve_thread(tmp_path):
    sock = str(tmp_path / "serve.sock")
    daemon = PricingDaemon(sock, engine=Explorer(parallel=False),
                           join_timeout_s=0.2)
    daemon.__enter__()
    unwedge = threading.Event()
    wedged = threading.Thread(target=unwedge.wait, daemon=True)
    wedged.start()
    real_thread = daemon._thread
    daemon._thread = wedged                 # simulate a wedged serve loop
    try:
        with pytest.raises(RuntimeError, match="still alive"):
            daemon.__exit__(None, None, None)
    finally:
        unwedge.set()
        real_thread.join(timeout=10)


@needs_sockets
def test_daemon_exit_raises_on_undrained_scheduler(tmp_path, monkeypatch):
    import repro_torch.serve.scheduler as sched_mod

    release = threading.Event()
    monkeypatch.setattr(sched_mod, "price",
                        lambda request, **kw: release.wait(120))
    sock = str(tmp_path / "serve.sock")
    sched = Scheduler(Explorer(parallel=False))
    with pytest.raises(RuntimeError, match="drain"):
        with PricingDaemon(sock, scheduler=sched,
                           join_timeout_s=0.2) as daemon:
            daemon.scheduler.submit(quick_request())
            time.sleep(0.05)                # worker enters the stuck price
    release.set()


@needs_sockets
def test_deadline_over_the_wire_degrades(tmp_path):
    sock = str(tmp_path / "serve.sock")
    with PricingDaemon(sock, engine=Explorer(parallel=False)) as _d:
        with PriceClient(sock, timeout=120) as client:
            degraded = client.price(quick_request(), deadline_s=0.0)
            assert degraded.degraded
            assert degraded.entries
            exact = client.price(quick_request())
            assert not exact.degraded
