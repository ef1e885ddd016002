"""Warm restarts of the port's pricing daemon (DESIGN.md §15): the serve
tests of ``tests/test_crash_resume.py`` run on ``repro_torch.serve`` — the
scheduler's memo journal restores warm answers byte for byte, a journal of
another version restores nothing, and a ``PriceClient`` with retries rides
a SIGKILL and a ``--resume`` restart of ``python -m repro_torch.serve`` —
and the module's daemon answering every op of the protocol.  Every
subprocess wait and every client has a timeout.
"""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import durable  # noqa: E402
from repro_torch.api import gpu_request  # noqa: E402
from repro_torch.core.access import LaunchConfig  # noqa: E402
from repro_torch.core.engine import Explorer  # noqa: E402
from repro_torch.core.machines import GPUMachine  # noqa: E402
from repro_torch.serve import PriceClient, Scheduler  # noqa: E402
from repro_torch.serve.daemon import can_bind_unix_sockets  # noqa: E402
from repro_torch.serve.schema import request_digest  # noqa: E402

SMALL = GPUMachine(
    name="A100/8", n_sms=13, clock_hz=1.41e9, l1_bytes=192 * 1024,
    l2_bytes=20 * 1024 * 1024 // 8, dram_bw=1400e9 / 8, l2_bw=5000e9 / 8,
    peak_flops_dp=9.7e12 / 8,
)
CONFIGS = [LaunchConfig(block=b) for b in [(64, 4, 2), (32, 4, 4), (8, 8, 8)]]
SRC = str(Path(__file__).resolve().parents[1] / "src")

needs_sockets = pytest.mark.skipif(
    not can_bind_unix_sockets(os.environ.get("TMPDIR", "/tmp")),
    reason="environment cannot bind Unix sockets")


def _request(r=1, domain=(16, 24, 32)):
    from repro_torch.core.specs import star_stencil_3d

    return gpu_request(star_stencil_3d(r=r, domain=domain), SMALL, CONFIGS)


def _fingerprint(report):
    return [(e.workload, e.machine, e.index, e.perf, e.limiter)
            for e in report.entries]


def _boot(cmd, sock):
    """Start ``python -m repro_torch.serve`` and wait (20 s at most) until
    its socket is bound."""
    proc = subprocess.Popen(cmd, env=dict(os.environ, PYTHONPATH=SRC),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    for _ in range(400):
        if os.path.exists(sock):
            return proc
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    proc.kill()
    raise RuntimeError("daemon never bound: " + proc.communicate(timeout=30)[0])


# ---- scheduler memo journal --------------------------------------------

def test_memo_journal_restores_warm_answers(tmp_path):
    memo = str(tmp_path / "memo.journal")
    req = _request(1)
    digest = request_digest(req)

    sched = Scheduler(Explorer(), memo_path=memo)
    fut = sched.submit(req, digest)
    wire = sched.encoded(digest, fut.result(120))
    assert sched.shutdown(wait=True)
    assert os.path.getsize(memo) > 0

    # a restore-less boot ignores the journal; a restoring boot is warm
    cold = Scheduler(Explorer(), memo_path=memo)
    assert cold.memo_restored == 0
    assert cold.shutdown(wait=True)

    warm = Scheduler(Explorer(), memo_path=memo, restore_memo=True)
    try:
        assert warm.memo_restored == 1
        fut2 = warm.submit(req, digest)
        wire2 = warm.encoded(digest, fut2.result(120))
        assert warm.counters["memo_hits"] == 1
        assert wire2 == wire                # bitwise-identical wire answer
    finally:
        assert warm.shutdown(wait=True)


def test_memo_journal_version_skew_restores_nothing(tmp_path):
    memo = str(tmp_path / "memo.journal")
    j = durable.Journal(memo)
    j.append(json.dumps({"kind": "repro-memo-journal",
                         "version": 999}).encode())
    j.append(json.dumps(["digest", "wire"]).encode())
    sched = Scheduler(Explorer(), memo_path=memo, restore_memo=True)
    try:
        assert sched.memo_restored == 0
    finally:
        assert sched.shutdown(wait=True)


# ---- daemon restart window ---------------------------------------------

@needs_sockets
def test_client_with_retries_rides_a_daemon_restart(tmp_path):
    """SIGKILL the daemon, construct a client against the dead socket,
    restart with ``--resume``: the client completes with the memoized
    (bitwise-identical) answer and the restarted daemon reports the
    restored entries."""
    sock = str(tmp_path / "s.sock")
    cache = str(tmp_path / "cache.inv")
    pidfile = str(tmp_path / "pid")
    cmd = [sys.executable, "-m", "repro_torch.serve", "--socket", sock,
           "--cache-path", cache, "--resume", "--pid-file", pidfile]

    req = _request(1)
    first = _boot(cmd, sock)
    second = None
    try:
        with PriceClient(sock, retries=0, timeout=60) as c:
            baseline = _fingerprint(c.price(req).report)
        assert int(open(pidfile).read()) == first.pid
        os.kill(first.pid, signal.SIGKILL)
        first.wait(timeout=30)

        # constructed against a dead socket: deferred connect + retries
        client = PriceClient(sock, retries=10, backoff_s=0.2, timeout=60)
        second = _boot(cmd, sock)
        assert _fingerprint(client.price(req).report) == baseline
        stats = client.stats()
        assert stats["memo_restored"] >= 1
        assert stats["memo_hits"] >= 1      # answered warm, no re-sweep
        client.close()
        os.kill(second.pid, signal.SIGTERM)     # graceful drain
        assert second.wait(timeout=30) == 0
        assert not os.path.exists(pidfile)
    finally:
        for proc in (first, second):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


@needs_sockets
def test_module_daemon_answers_every_op(tmp_path):
    """``python -m repro_torch.serve`` answers ``ping``, ``price``,
    ``stats``, ``trace`` and ``shutdown``, exits 0 on the last, and writes
    its span timeline to ``--trace-out``."""
    sock = str(tmp_path / "s.sock")
    trace_out = tmp_path / "trace.json"
    proc = _boot([sys.executable, "-m", "repro_torch.serve", "--socket", sock,
                  "--trace-out", str(trace_out), "--max-queue", "4"], sock)
    try:
        with PriceClient(sock, timeout=60) as c:
            assert c.ping()
            result = c.price(_request(1))
            assert len(result.entries) == len(CONFIGS)
            stats = c.stats()
            assert stats["requests"] == stats["keys_priced"] == 1
            trace = c.trace()
            assert "serve.price" in {e["name"] for e in trace["traceEvents"]}
            c.shutdown_server()
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert out.startswith(f"repro_torch.serve: listening on {sock}")
        assert "serve.drain" in {e["name"] for e in
                                 json.loads(trace_out.read_text())["traceEvents"]}
        assert not os.path.exists(sock)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
