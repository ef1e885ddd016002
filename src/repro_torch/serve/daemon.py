"""The pricing daemon: a long-lived estimator behind a Unix socket.

``python -m repro_torch.serve --socket /tmp/repro_torch.sock --cache-path inv``
starts one process that loads the ``InvariantCache`` (and, through it, the
memoized stream tables) once and serves every code-generation run on the
machine.  Protocol: newline-delimited JSON over a local stream socket, one
message per line, every line carrying ``schema_version``.

Client -> server ops:
    {"op": "price", "id": <any>, "request": <encoded PriceRequest>,
     "deadline_s": <optional seconds>}
    {"op": "stats"} | {"op": "trace"} | {"op": "ping"} | {"op": "shutdown"}

Server -> client lines:
    {"ok": true, "op": "result", "id": ..., "digest": ..., "result": ...}
    {"ok": true, "op": "stats"/"pong"/"bye", ...}
    {"ok": true, "op": "trace", "enabled": ..., "trace": <Chrome JSON>}
    {"ok": false, "id": ..., "error": "...", "error_class": "...",
     "retry_after_s": <only on backpressure rejections>}

``stats`` carries the scheduler's live counters plus the process-wide
``obs.metrics`` snapshot; ``trace`` ships the daemon's collected span
timeline as Chrome trace-event JSON (empty while telemetry is disabled —
start with ``--trace-out`` or ``REPRO_TRACE_OUT`` to collect).

A connection may pipeline many ``price`` ops; results stream back **as
they complete** (matched by ``id``, not by order) — a memo-hit answer for
request 50 does not wait behind a cold sweep for request 1.

Failure model (DESIGN.md §13): every error line names the server-side
exception class so clients can distinguish retryable conditions
(``QueueFullError`` backpressure) from permanent ones; a client that
disconnects mid-request has its outstanding submissions cancelled, so an
abandoned cold sweep still queued never runs; and shutdown is honest — a
serve or scheduler thread that fails to drain raises/exits nonzero instead
of silently leaking.

Durability (DESIGN.md §15): SIGTERM/SIGINT trigger the same graceful drain
as the ``shutdown`` op — stop accepting, finish or cancel queued work,
persist the invariant cache and a versioned scheduler-memo snapshot.
``--resume`` replays both journals on boot (plus the sweep checkpoint
journal at ``<cache-path>.sweeps``), so restarts are zero-warm-loss even
after a SIGKILL; ``--pid-file`` lets supervisors target the process.

A copy of ``repro.serve.daemon`` with the same ops, wire lines and flags.
Its default socket is its own (``DEFAULT_SOCKET``, in the temporary
directory), so that both packages' daemons can run on one machine, and its
log lines say ``repro_torch.serve:``.  The daemon prices on the host and
never touches a GPU: nothing on its path initialises CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import socketserver
import sys
import tempfile
import threading

from repro_torch import durable, faults, obs
from repro_torch.core.engine import Explorer

from .scheduler import QueueFullError, Scheduler
from .schema import SCHEMA_VERSION, decode, encode, request_digest

DEFAULT_SOCKET = os.path.join(tempfile.gettempdir(), "repro_torch-serve.sock")


def _line(payload: dict) -> bytes:
    payload.setdefault("schema_version", SCHEMA_VERSION)
    return (json.dumps(payload, separators=(",", ":")) + "\n").encode()


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        server: PricingDaemon = self.server  # type: ignore[assignment]
        write_lock = threading.Lock()
        submitted: list = []    # futures owned by this connection

        def send(payload: dict):
            if faults.drop_point("serve.socket_drop"):
                # injected connection loss: sever this client mid-response
                # (its retry path must recover; see bench_chaos_soak)
                try:
                    self.connection.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                return
            data = _line(payload)
            with write_lock:
                try:
                    self.wfile.write(data)
                    self.wfile.flush()
                except (BrokenPipeError, OSError, ValueError):
                    # client gone (ValueError: wfile already closed after
                    # the handler returned) — nobody is listening
                    pass

        try:
            for raw in self.rfile:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    msg = json.loads(raw)
                    op = msg.get("op")
                except Exception as exc:
                    send({"ok": False, "error": f"bad message: {exc}",
                          "error_class": type(exc).__name__})
                    continue
                # the span covers dispatch (for `price`: decode + submit;
                # the sweep itself runs under the scheduler's serve.* spans)
                with obs.span("daemon.op", "serve", op=str(op)):
                    if op == "ping":
                        send({"ok": True, "op": "pong"})
                    elif op == "stats":
                        send({"ok": True, "op": "stats",
                              "stats": server.scheduler.stats()})
                    elif op == "trace":
                        send({"ok": True, "op": "trace",
                              "enabled": obs.enabled(),
                              "trace": obs.chrome_trace()})
                    elif op == "shutdown":
                        send({"ok": True, "op": "bye"})
                        server.request_shutdown()
                        return
                    elif op == "price":
                        self._price(server, msg, send, submitted)
                    else:
                        send({"ok": False, "id": msg.get("id"),
                              "error": f"unknown op {op!r}",
                              "error_class": "ValueError"})
        finally:
            # client gone: detach every future this connection still owns —
            # a queued request nobody is waiting for must not burn a sweep
            for fut in submitted:
                if not fut.done():
                    server.scheduler.cancel(fut)

    def _price(self, server, msg, send, submitted):
        req_id = msg.get("id")
        try:
            version = msg.get("schema_version")
            if version != SCHEMA_VERSION:
                raise ValueError(f"schema version {version} != "
                                 f"{SCHEMA_VERSION}")
            request = decode(msg["request"])
            digest = request_digest(request)
            deadline_s = msg.get("deadline_s")
            if deadline_s is not None:
                deadline_s = float(deadline_s)
        except Exception as exc:
            send({"ok": False, "id": req_id,
                  "error": f"{type(exc).__name__}: {exc}",
                  "error_class": type(exc).__name__})
            return

        def on_done(fut):
            if fut.cancelled():
                return              # client already hung up
            try:
                result = fut.result()
            except Exception as exc:
                send({"ok": False, "id": req_id, "digest": digest,
                      "error": f"{type(exc).__name__}: {exc}",
                      "error_class": type(exc).__name__})
                return
            # memoized wire rendering: warm answers re-send cached text
            wire = server.scheduler.encoded(digest, result)
            body = json.loads(wire)["body"]
            send({"ok": True, "op": "result", "id": req_id,
                  "digest": digest, "result": body})

        try:
            fut = server.scheduler.submit(request, digest,
                                          deadline_s=deadline_s)
        except QueueFullError as exc:    # backpressure: explicit + retryable
            send({"ok": False, "id": req_id, "digest": digest,
                  "error": str(exc), "error_class": "QueueFullError",
                  "retry_after_s": exc.retry_after_s})
            return
        except RuntimeError as exc:      # shutting down
            send({"ok": False, "id": req_id, "error": str(exc),
                  "error_class": type(exc).__name__})
            return
        submitted.append(fut)
        fut.add_done_callback(on_done)


class PricingDaemon(socketserver.ThreadingUnixStreamServer):
    """Threaded Unix-socket server wrapping one shared ``Scheduler``."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, socket_path: str, *, engine: Explorer | None = None,
                 scheduler: Scheduler | None = None, memo_entries: int = 1024,
                 join_timeout_s: float = 10.0):
        self.socket_path = os.fspath(socket_path)
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self.scheduler = scheduler or Scheduler(engine,
                                                memo_entries=memo_entries)
        self.join_timeout_s = join_timeout_s
        self._shutdown_requested = threading.Event()
        super().__init__(self.socket_path, _Handler)

    def request_shutdown(self):
        """Asynchronous clean-exit request (the ``shutdown`` op)."""
        if not self._shutdown_requested.is_set():
            self._shutdown_requested.set()
            threading.Thread(target=self.shutdown, daemon=True).start()

    def close(self) -> bool:
        """Stop serving, drain the scheduler, persist cache + memo.

        The graceful-drain path (DESIGN.md §15): stop accepting
        connections, let the scheduler finish or cancel queued work, then
        persist the invariant cache and the memo snapshot so the next boot
        (``--resume``) starts warm.  Returns False when the scheduler
        worker failed to drain within ``join_timeout_s`` (logged to
        stderr) — ``serve``/``main`` turn that into a nonzero exit.
        """
        with obs.span("serve.drain", "serve"):
            self.server_close()
            drained = self.scheduler.shutdown(wait=True,
                                              timeout=self.join_timeout_s)
        if not drained:
            print(f"repro_torch.serve: scheduler worker still running after "
                  f"{self.join_timeout_s}s drain timeout; cache saved, "
                  f"worker abandoned", file=sys.stderr)
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        return drained

    # context manager: `with PricingDaemon(...) as d:` serves in background
    def __enter__(self):
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self.shutdown()
        self._thread.join(timeout=self.join_timeout_s)
        stuck = self._thread.is_alive()
        drained = self.close()
        if stuck:
            # never swallow a wedged serve thread: the caller believes the
            # daemon is gone while it still holds the socket/scheduler
            raise RuntimeError(
                f"serve thread still alive {self.join_timeout_s}s after "
                f"shutdown; a handler is wedged")
        if not drained and exc == (None, None, None):
            raise RuntimeError(
                f"scheduler worker failed to drain within "
                f"{self.join_timeout_s}s at daemon exit")
        return False


def serve(socket_path: str, *, install_signals: bool = False,
          **daemon_kw) -> bool:
    """Blocking entry point used by ``python -m repro_torch.serve``.

    With ``install_signals`` (only valid from the main thread), SIGTERM
    and SIGINT trigger the same graceful drain as the ``shutdown`` op:
    stop accepting, finish or cancel queued work, persist cache + memo
    snapshot — so supervisors restarting the daemon lose no warmth.
    Returns True on a clean drain, False when shutdown left a wedged
    worker behind (``main`` exits nonzero so supervisors notice).
    """
    daemon = PricingDaemon(socket_path, **daemon_kw)
    if install_signals:
        def _drain(signum, frame):
            daemon.request_shutdown()

        signal.signal(signal.SIGTERM, _drain)
        signal.signal(signal.SIGINT, _drain)
    try:
        daemon.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        clean = daemon.close()
    return clean


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="long-lived analytical-pricing daemon")
    ap.add_argument("--socket", default=DEFAULT_SOCKET,
                    help="Unix socket path (default %(default)s)")
    ap.add_argument("--cache-path", default=None,
                    help="persist the invariant cache here (warm restarts)")
    ap.add_argument("--parallel", action="store_true",
                    help="evaluate structural tasks in a worker pool")
    ap.add_argument("--max-workers", type=int, default=None)
    ap.add_argument("--cache-max-entries", type=int, default=None)
    ap.add_argument("--cache-max-bytes", type=int, default=None)
    ap.add_argument("--memo-entries", type=int, default=1024,
                    help="result-memo LRU size (default %(default)s)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the request queue; beyond it submissions "
                         "are rejected with retry-after backpressure")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="default per-request deadline; past it requests "
                         "degrade to the closed-form bound ranking")
    ap.add_argument("--trace-out", default=None,
                    help="collect telemetry spans and write a Chrome "
                         "trace-event JSON here on exit (live timelines "
                         "via the 'trace' op)")
    ap.add_argument("--memo-path", default=None,
                    help="journal the scheduler result memo here (default "
                         "<cache-path>.memo when --resume is set): entries "
                         "append as they memoize, so even a SIGKILL'd "
                         "daemon restarts warm")
    ap.add_argument("--resume", action="store_true",
                    help="restore durable state on boot: replay the memo "
                         "journal and the sweep checkpoint journal "
                         "(<cache-path>.sweeps), so a restarted daemon "
                         "answers memoized digests warm and never "
                         "re-prices cells a killed sweep completed")
    ap.add_argument("--pid-file", default=None,
                    help="write the daemon pid here (atomic, removed on "
                         "exit) so supervisors and the CI smoke job can "
                         "target restarts")
    args = ap.parse_args(argv)
    if args.trace_out:
        obs.enable()
    memo_path = args.memo_path
    resume_path = None
    if args.resume and args.cache_path:
        memo_path = memo_path or args.cache_path + ".memo"
        resume_path = args.cache_path + ".sweeps"
    engine = Explorer(parallel=args.parallel, max_workers=args.max_workers,
                      cache_path=args.cache_path,
                      cache_max_entries=args.cache_max_entries,
                      cache_max_bytes=args.cache_max_bytes,
                      resume=resume_path)
    scheduler = Scheduler(engine, memo_entries=args.memo_entries,
                          max_queue=args.max_queue,
                          default_deadline_s=args.deadline_s,
                          memo_path=memo_path, restore_memo=args.resume)
    if args.pid_file:
        durable.atomic_write(args.pid_file, f"{os.getpid()}\n")
    print(f"repro_torch.serve: listening on {args.socket} "
          f"(cache: {args.cache_path or 'in-memory'}, "
          f"{engine.cache.loaded_entries} entries warm, "
          f"{scheduler.memo_restored} memo entries restored)")
    try:
        clean = serve(args.socket, scheduler=scheduler,
                      install_signals=True)
    finally:
        if args.pid_file:
            try:
                os.unlink(args.pid_file)
            except OSError:
                pass
    if args.trace_out and obs.spans():
        obs.write_trace(args.trace_out)
        print(f"repro_torch.serve: trace written to {args.trace_out}")
    return 0 if clean else 1


# client availability probe used by tests/benches
def can_bind_unix_sockets(tmpdir: str) -> bool:
    path = os.path.join(tmpdir, "probe.sock")
    try:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.bind(path)
        s.close()
        os.unlink(path)
        return True
    except OSError:
        return False


__all__ = ["DEFAULT_SOCKET", "PricingDaemon", "serve", "main",
           "can_bind_unix_sockets"]
