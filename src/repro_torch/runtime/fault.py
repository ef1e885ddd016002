"""Fault-tolerance runtime: failure detection, elastic re-mesh, stragglers (a
copy of ``repro.runtime.fault``, pure Python).

On a real cluster these hooks sit between the launcher and the coordinator
service; here they are implemented against an in-process host registry, so
the logic (quorum, re-mesh shape selection, straggler z-scores,
restart-from-checkpoint flow) is testable on the CPU.
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class HostState:
    host_id: int
    last_heartbeat: float
    alive: bool = True


class FailureDetector:
    """Heartbeat-timeout failure detection over the host set."""

    def __init__(self, n_hosts: int, timeout_s: float = 30.0, clock=time.monotonic):
        self.clock = clock
        self.timeout_s = timeout_s
        self.hosts = {h: HostState(h, clock()) for h in range(n_hosts)}

    def heartbeat(self, host_id: int):
        st = self.hosts[host_id]
        st.last_heartbeat = self.clock()
        st.alive = True

    def sweep(self) -> list[int]:
        """Mark hosts dead on timeout; returns newly dead host ids."""
        now = self.clock()
        dead = []
        for st in self.hosts.values():
            if st.alive and now - st.last_heartbeat > self.timeout_s:
                st.alive = False
                dead.append(st.host_id)
        return dead

    @property
    def alive_hosts(self) -> list[int]:
        return [h for h, st in self.hosts.items() if st.alive]


def elastic_mesh_shape(n_chips_alive: int, model_parallel: int,
                       pod_size: int = 256) -> tuple | None:
    """Largest (pod, data, model) mesh fitting the surviving chips.

    Keeps the model axis fixed (param layout unchanged -> cheap reshard) and
    shrinks data/pod: the data axis must stay a power-of-two divisor so batch
    re-sharding stays aligned.
    """
    if n_chips_alive < model_parallel:
        return None
    avail_data = n_chips_alive // model_parallel
    data = 1 << (avail_data.bit_length() - 1)  # largest pow2 <= avail
    pods = max(1, (model_parallel * data) // pod_size)
    if pods > 1:
        return (pods, data // pods, model_parallel)
    return (data, model_parallel)


class StragglerTracker:
    """Per-host step-time outlier detection (z-score over a sliding window)."""

    def __init__(self, n_hosts: int, window: int = 32, z_threshold: float = 3.0):
        self.times = {h: deque(maxlen=window) for h in range(n_hosts)}
        self.z = z_threshold

    def record(self, host_id: int, step_time_s: float):
        self.times[host_id].append(step_time_s)

    def stragglers(self) -> list[int]:
        means = {
            h: sum(t) / len(t) for h, t in self.times.items() if len(t) >= 4
        }
        if len(means) < 2:
            return []
        vals = list(means.values())
        mu = sum(vals) / len(vals)
        var = sum((v - mu) ** 2 for v in vals) / len(vals)
        sd = math.sqrt(var) or 1e-9
        return [h for h, v in means.items() if (v - mu) / sd > self.z]


@dataclass
class RecoveryPlan:
    action: str               # "continue" | "remesh" | "halt"
    mesh_shape: tuple | None = None
    restore_step: int | None = None
    evicted_hosts: list = field(default_factory=list)


def plan_recovery(detector: FailureDetector, tracker: StragglerTracker,
                  chips_per_host: int, model_parallel: int,
                  latest_ckpt_step: int | None) -> RecoveryPlan:
    """The launcher's decision procedure after each sweep."""
    dead = detector.sweep()
    stragglers = tracker.stragglers()
    evict = sorted(set(dead) | set(stragglers))
    if not evict:
        return RecoveryPlan("continue")
    alive = [h for h in detector.alive_hosts if h not in evict]
    shape = elastic_mesh_shape(len(alive) * chips_per_host, model_parallel)
    if shape is None:
        return RecoveryPlan("halt", evicted_hosts=evict)
    return RecoveryPlan("remesh", mesh_shape=shape,
                        restore_step=latest_ckpt_step, evicted_hosts=evict)
