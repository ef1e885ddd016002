"""Client for the pricing daemon.

    from repro_torch.api import gpu_request
    from repro_torch.serve.client import PriceClient
    from repro_torch.serve.daemon import DEFAULT_SOCKET

    with PriceClient(DEFAULT_SOCKET) as c:
        result = c.price(gpu_request(spec, "A100", top_k=5))
        print(result.report.comparison_table())

``price_many`` pipelines a batch over one connection and yields results to
``on_result`` as the daemon streams them back (completion order), while the
returned list preserves request order.

Retries (DESIGN.md §13): with ``retries=N`` the client survives dropped
connections and ``QueueFullError`` backpressure by reconnecting and
resubmitting only the requests still unanswered, after a jittered
exponential backoff (honoring the server's ``retry_after_s`` hint).  The
retry is idempotent by construction: requests are identified server-side
by their structural ``request_digest``, so a resubmission of work the
daemon already finished (or still has in flight) resolves as a memo hit or
in-flight join — never a duplicate sweep — and results already delivered
to ``on_result`` are never delivered twice.

The same retry budget rides daemon *restart windows* (DESIGN.md §15): a
connection refused or reset while the daemon is down is just another
retryable failure, so a client with ``retries > 0`` constructed against a
dead socket — or mid-``price_many`` when the daemon is killed — reconnects
with backoff and completes once the daemon is back (warm, via its memo
journal).  Only with ``retries=0`` does construction require a live daemon.

A copy of ``repro.serve.client``: its requests and answers are the
reference's bytes, so it talks to either package's daemon.
"""
from __future__ import annotations

import json
import os
import random
import socket
import threading
import time

from repro_torch.api import PriceRequest, PriceResult

from .schema import SCHEMA_VERSION, decode, encode, request_digest

# server-side error classes that a retry can plausibly cure
_RETRYABLE = frozenset({"QueueFullError", "ConnectionClosed"})

_MAX_BACKOFF_S = 5.0


class ServeError(RuntimeError):
    """An error line from the daemon (bad request, engine failure, skew).

    ``error_class`` names the server-side exception class (None for
    transport-level failures the client synthesizes itself);
    ``retry_after_s`` carries the server's backpressure hint when present.
    """

    def __init__(self, message: str, *, error_class: str | None = None,
                 retry_after_s: float | None = None):
        super().__init__(message)
        self.error_class = error_class
        self.retry_after_s = retry_after_s

    @property
    def retryable(self) -> bool:
        return self.error_class in _RETRYABLE


class PriceClient:
    def __init__(self, socket_path: str, *, timeout: float | None = None,
                 retries: int = 0, backoff_s: float = 0.05):
        self._path = os.fspath(socket_path)
        self._timeout = timeout
        self.retries = retries
        self.backoff_s = backoff_s
        self._send_lock = threading.Lock()
        self._next_id = 0
        self._sock: socket.socket | None = None
        self._rfile = None
        self._closed = False
        # With a retry budget, a refused connect is deferred to the first
        # op's retry loop — the daemon may be mid-restart right now.
        try:
            self._connect()
        except OSError:
            if self.retries <= 0:
                raise

    # ---- connection lifecycle ------------------------------------------
    def _connect(self) -> None:
        """Open the socket, closing it again on ANY failure — a refused or
        timed-out connect must not leak the half-built fd."""
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            if self._timeout is not None:
                sock.settimeout(self._timeout)
            sock.connect(self._path)
            rfile = sock.makefile("rb")
        except BaseException:
            sock.close()
            raise
        self._sock, self._rfile = sock, rfile

    def _reconnect(self) -> None:
        # an internal redial, not a user close — leave the client usable
        self.close()
        self._closed = False
        self._connect()

    def close(self) -> None:
        """Idempotent: safe after a failed connect and safe to call twice."""
        self._closed = True
        rfile, sock = self._rfile, self._sock
        self._rfile = self._sock = None
        try:
            if rfile is not None:
                rfile.close()
        finally:
            if sock is not None:
                sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ---- wire plumbing -------------------------------------------------
    def _send(self, payload: dict) -> None:
        if self._sock is None:
            raise OSError("client is closed")
        payload.setdefault("schema_version", SCHEMA_VERSION)
        data = (json.dumps(payload, separators=(",", ":")) + "\n").encode()
        with self._send_lock:
            self._sock.sendall(data)

    def _recv(self) -> dict:
        line = self._rfile.readline()
        if not line:
            raise ServeError("daemon closed the connection",
                             error_class="ConnectionClosed")
        return json.loads(line)

    def _take_id(self) -> int:
        with self._send_lock:
            self._next_id += 1
            return self._next_id

    # ---- ops -----------------------------------------------------------
    def ping(self) -> bool:
        self._send({"op": "ping"})
        return self._recv().get("op") == "pong"

    def stats(self) -> dict:
        self._send({"op": "stats"})
        msg = self._recv()
        if not msg.get("ok"):
            raise _error_from(msg, "stats failed")
        return msg["stats"]

    def trace(self) -> dict:
        """The daemon's span timeline as Chrome trace-event JSON
        (``{"traceEvents": [...]}``; empty while telemetry is disabled
        server-side)."""
        self._send({"op": "trace"})
        msg = self._recv()
        if not msg.get("ok"):
            raise _error_from(msg, "trace failed")
        return msg["trace"]

    def shutdown_server(self) -> None:
        self._send({"op": "shutdown"})
        try:
            self._recv()
        except ServeError:
            pass

    def price(self, request: PriceRequest,
              deadline_s: float | None = None) -> PriceResult:
        """Price one request, blocking until its result streams back.

        ``deadline_s`` bounds server-side work: past it the daemon answers
        with the closed-form bound ranking flagged ``degraded=True``.
        """
        return self.price_many([request], deadline_s=deadline_s)[0]

    def price_many(self, requests, on_result=None,
                   deadline_s: float | None = None) -> list:
        """Pipeline a batch; returns results in request order.

        ``on_result(index, result)`` fires in the daemon's completion
        order — a warm (memoized) answer arrives without waiting for cold
        sweeps submitted before it — and fires exactly once per request
        even across retries.
        """
        if self._closed:
            raise OSError("client is closed")
        requests = list(requests)
        out: list = [None] * len(requests)
        done = [False] * len(requests)
        # digests key the retry: the server dedupes resubmissions on them
        digests = [request_digest(r) for r in requests]
        attempt = 0
        while True:
            try:
                self._attempt(requests, out, done, on_result, deadline_s)
                return out
            except (ServeError, OSError) as exc:
                retryable = (isinstance(exc, OSError)
                             or (isinstance(exc, ServeError)
                                 and exc.retryable))
                if not retryable or attempt >= self.retries:
                    raise
                attempt += 1
                time.sleep(self._retry_delay(exc, digests, attempt))
                try:
                    self._reconnect()
                except OSError:
                    if attempt >= self.retries:
                        raise

    def _attempt(self, requests, out, done, on_result, deadline_s) -> None:
        """One submission round over the current connection: send every
        still-unanswered request, then drain until each has an answer."""
        if self._sock is None:      # deferred or dropped connect
            self._connect()
        ids = {}
        for i, request in enumerate(requests):
            if done[i]:
                continue
            rid = self._take_id()
            ids[rid] = i
            msg = {"op": "price", "id": rid, "request": encode(request)}
            if deadline_s is not None:
                msg["deadline_s"] = deadline_s
            self._send(msg)
        first_error = None
        while ids:
            msg = self._recv()
            rid = msg.get("id")
            if rid not in ids:
                continue            # e.g. an interleaved pong
            i = ids.pop(rid)
            if not msg.get("ok"):
                err = _error_from(msg, "pricing failed")
                if err.retryable:
                    raise err       # resubmit the unanswered remainder
                first_error = first_error or err
                continue
            result = decode(msg["result"])
            out[i] = result
            done[i] = True
            if on_result is not None:
                on_result(i, result)
        if first_error is not None:
            raise first_error

    def _retry_delay(self, exc, digests, attempt) -> float:
        """Jittered exponential backoff, keyed on the request digests so
        two clients retrying the same burst do not stampede in lock-step,
        floored at the server's explicit retry-after hint."""
        seed = f"{digests[0] if digests else ''}:{attempt}"
        rng = random.Random(seed)
        delay = self.backoff_s * (2 ** (attempt - 1)) * (0.5 + rng.random())
        hinted = getattr(exc, "retry_after_s", None)
        if hinted:
            delay = max(delay, float(hinted))
        return min(delay, _MAX_BACKOFF_S)


def _error_from(msg: dict, fallback: str) -> ServeError:
    return ServeError(msg.get("error", fallback),
                      error_class=msg.get("error_class"),
                      retry_after_s=msg.get("retry_after_s"))


__all__ = ["PriceClient", "ServeError"]
