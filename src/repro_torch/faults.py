"""Deterministic fault injection for the pricing stack (DESIGN.md §13).

A copy of ``repro.faults``; plans and the environment variable are the same.

The failure model is enforced, not aspirational: every layer of the stack
(worker pool, invariant cache, scheduler, daemon, client) carries named
*injection sites*, and a seed-keyed :class:`FaultPlan` decides — purely as a
function of ``(seed, site, invocation counter)`` — whether a given site call
fires.  The recovery contract the chaos suite gates (``never wrong, never
hung``) is then testable: under any plan, a request either completes
bitwise-identically to the fault-free run or is explicitly flagged
degraded/rejected.

Sites (the taxonomy; §13 documents the recovery contract per site):

    ``pool.worker_crash``   worker process exits mid-chunk (``os._exit``)
    ``pool.worker_hang``    worker process sleeps ``arg`` seconds mid-chunk
    ``invcache.load``       persisted cache blob read back corrupted
    ``serve.socket_drop``   daemon drops the client connection mid-response
    ``client.drop``         client abandons a request mid-flight (driven by
                            the chaos benches; no library-side hook needed)
    ``proc.kill``           SIGKILL the current process *after* a journal
                            frame commits (``repro_torch.durable``) — ``at=(k,)``
                            dies with exactly ``k + 1`` frames durable
    ``io.torn_write``       a journal append writes only a prefix of its
                            frame yet reports success (the lying
                            filesystem); replay must recover the committed
                            prefix and quarantine the tail

Plans install via the API (:func:`install` / :func:`injected`) or the
``REPRO_FAULT_PLAN`` environment variable (JSON, see :func:`plan_from_env`)
— the env path is how pool *worker processes* pick the plan up regardless of
multiprocessing start method.  With no plan installed every site is a single
``None``-check: zero overhead in production.

Determinism: ``at`` indices fire on exact per-process invocation counts;
``rate`` decisions hash ``(seed, site, pid, counter)`` — reproducible within
a process, diverse across pool workers (so a fleet of workers does not crash
in lock-step).  ``token=True`` additionally bounds *global* fires across
processes by claiming ``O_EXCL`` token files under ``plan.token_dir``:
``max_fires=1, token=True`` means "exactly once across the whole pool", and
the token files double as the parent-visible record that a worker-side fault
actually fired.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass

ENV_VAR = "REPRO_FAULT_PLAN"

#: every site the stack defines — plans naming unknown sites are rejected
#: loudly at install time (a typo'd site would otherwise never fire)
SITES = frozenset({
    "pool.worker_crash",
    "pool.worker_hang",
    "invcache.load",
    "serve.socket_drop",
    "client.drop",
    "proc.kill",
    "io.torn_write",
})


@dataclass(frozen=True)
class FaultSpec:
    """How one site misbehaves.

    ``at``: exact 0-based invocation indices (per process) that fire.
    ``rate``: per-invocation probability, decided by a deterministic hash.
    ``max_fires``: per-process cap on fires (None = unbounded).
    ``arg``: site payload — hang seconds, crash exit code (default 13).
    ``token``: claim a cross-process token file per fire; a fire that cannot
    claim one is suppressed, bounding fires globally, not just per process.
    """

    rate: float = 0.0
    at: tuple = ()
    max_fires: int | None = None
    arg: float = 0.0
    token: bool = False

    def __post_init__(self):
        object.__setattr__(self, "at", tuple(int(i) for i in self.at))
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"fault rate {self.rate} outside [0, 1]")


@dataclass(frozen=True)
class FaultPlan:
    """A seed-keyed mapping of site -> :class:`FaultSpec`."""

    seed: int = 0
    faults: tuple = ()              # ((site, FaultSpec), ...)
    token_dir: str | None = None

    def __post_init__(self):
        items = self.faults
        if isinstance(items, dict):
            items = tuple(items.items())
        items = tuple((str(site), spec) for site, spec in items)
        for site, spec in items:
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r} "
                                 f"(known: {sorted(SITES)})")
            if not isinstance(spec, FaultSpec):
                raise ValueError(f"fault for {site!r} must be a FaultSpec")
            if spec.token and not self.token_dir:
                raise ValueError(f"site {site!r} uses token=True but the "
                                 f"plan has no token_dir")
        object.__setattr__(self, "faults", items)

    def spec(self, site: str) -> FaultSpec | None:
        for s, spec in self.faults:
            if s == site:
                return spec
        return None

    def to_json(self) -> str:
        """Round-trippable JSON — hand this to ``REPRO_FAULT_PLAN`` so pool
        worker processes (any start method) adopt the same plan."""
        return json.dumps({
            "seed": self.seed,
            "token_dir": self.token_dir,
            "faults": {
                site: {"rate": spec.rate, "at": list(spec.at),
                       "max_fires": spec.max_fires, "arg": spec.arg,
                       "token": spec.token}
                for site, spec in self.faults
            },
        }, separators=(",", ":"))

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        faults = {
            site: FaultSpec(**{k: v for k, v in (spec or {}).items()
                               if v is not None})
            for site, spec in (d.get("faults") or {}).items()
        }
        return cls(seed=int(d.get("seed", 0)), faults=faults,
                   token_dir=d.get("token_dir"))


def _decision(seed: int, site: str, salt: int, n: int) -> float:
    h = hashlib.sha256(f"{seed}:{site}:{salt}:{n}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


class FaultInjector:
    """Per-process fault decision engine over one plan; thread-safe."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._calls: dict = {}
        self._fired: dict = {}

    def fires(self, site: str) -> FaultSpec | None:
        spec = self.plan.spec(site)
        if spec is None:
            return None
        with self._lock:
            n = self._calls.get(site, 0)
            self._calls[site] = n + 1
            fired = self._fired.get(site, 0)
            if spec.max_fires is not None and fired >= spec.max_fires:
                return None
            hit = n in spec.at or (
                spec.rate > 0.0
                and _decision(self.plan.seed, site, os.getpid(), n) < spec.rate
            )
            if not hit:
                return None
            if spec.token and not self._claim(site, fired):
                return None
            self._fired[site] = fired + 1
        return spec

    def _claim(self, site: str, k: int) -> bool:
        """Claim the k-th global token for ``site`` — exactly one process
        wins each; losers suppress the fire."""
        name = f"{site.replace('.', '_')}.{k}.token"
        path = os.path.join(self.plan.token_dir, name)
        try:
            os.makedirs(self.plan.token_dir, exist_ok=True)
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except OSError:
            return False
        with os.fdopen(fd, "w") as f:
            f.write(f"pid={os.getpid()}\n")
        return True

    def stats(self) -> dict:
        with self._lock:
            return {site: {"calls": self._calls.get(site, 0),
                           "fired": self._fired.get(site, 0)}
                    for site in set(self._calls) | set(self._fired)}


# ---- module-level plan management ---------------------------------------
_INJECTOR: FaultInjector | None = None


def install(plan: FaultPlan) -> FaultInjector:
    """Activate ``plan`` in this process (replacing any active one)."""
    global _INJECTOR
    _INJECTOR = FaultInjector(plan)
    return _INJECTOR


def clear() -> None:
    global _INJECTOR
    _INJECTOR = None


def active() -> FaultPlan | None:
    return _INJECTOR.plan if _INJECTOR is not None else None


def stats() -> dict:
    return _INJECTOR.stats() if _INJECTOR is not None else {}


@contextlib.contextmanager
def injected(plan: FaultPlan):
    """Scoped installation — restores the previous plan on exit."""
    global _INJECTOR
    prev = _INJECTOR
    _INJECTOR = FaultInjector(plan)
    try:
        yield _INJECTOR
    finally:
        _INJECTOR = prev


def plan_from_env(text: str | None = None) -> FaultPlan | None:
    """Parse ``REPRO_FAULT_PLAN`` (or ``text``); None when unset.

    Malformed plans raise ``ValueError`` — a chaos run that silently
    injected nothing would pass its gates vacuously.
    """
    text = os.environ.get(ENV_VAR) if text is None else text
    if not text:
        return None
    try:
        d = json.loads(text)
    except json.JSONDecodeError as exc:
        raise ValueError(f"{ENV_VAR} is not valid JSON: {exc}") from exc
    if not isinstance(d, dict):
        raise ValueError(f"{ENV_VAR} must be a JSON object")
    return FaultPlan.from_dict(d)


def ensure_env_plan() -> None:
    """Install the env-var plan if no plan is active yet.

    Called at pool-worker entry so forked workers (which inherit a parent
    module state from *before* the env var was set) and spawned/forkserver
    workers (fresh interpreters) both converge on the same plan.
    """
    if _INJECTOR is None and os.environ.get(ENV_VAR):
        install(plan_from_env())


# ---- injection-site helpers ----------------------------------------------
def fire(site: str) -> FaultSpec | None:
    """The universal site check: None when no plan is active (the production
    fast path — one global load and an ``is None`` test)."""
    inj = _INJECTOR
    return None if inj is None else inj.fires(site)


def crash_point(site: str) -> None:
    """Site that kills the current process outright when it fires."""
    spec = fire(site)
    if spec is not None:
        os._exit(int(spec.arg) or 13)


def kill_point(site: str) -> None:
    """Site that SIGKILLs the current process when it fires — the hard
    death the durability layer must survive: no atexit hooks, no flushes,
    no graceful drain.  (``crash_point`` is the softer ``os._exit``.)"""
    spec = fire(site)
    if spec is not None:
        import signal

        os.kill(os.getpid(), signal.SIGKILL)


def hang_point(site: str) -> None:
    """Site that wedges the current thread for ``spec.arg`` seconds."""
    spec = fire(site)
    if spec is not None:
        time.sleep(spec.arg or 3600.0)


def drop_point(site: str) -> bool:
    """Site that asks its caller to sever a connection when True."""
    return fire(site) is not None


def corrupt_bytes(site: str, data: bytes) -> bytes:
    """Site that flips one deterministic byte of ``data`` when it fires."""
    spec = fire(site)
    if spec is None or not data:
        return data
    plan = _INJECTOR.plan if _INJECTOR is not None else FaultPlan()
    idx = int(_decision(plan.seed, site, 0, len(data)) * len(data))
    out = bytearray(data)
    out[idx] ^= 0xFF
    return bytes(out)


__all__ = [
    "ENV_VAR", "SITES", "FaultSpec", "FaultPlan", "FaultInjector",
    "install", "clear", "active", "stats", "injected", "plan_from_env",
    "ensure_env_plan", "fire", "crash_point", "kill_point", "hang_point",
    "drop_point", "corrupt_bytes",
]

# pool worker processes created by non-fork start methods import this module
# fresh — adopt the env plan immediately so their very first chunk is covered
ensure_env_plan()
