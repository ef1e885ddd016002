"""Deterministic synthetic token pipeline with host sharding and prefetch (a
copy of ``repro.data.pipeline``, numpy only).

Each host generates only its local shard of the global batch, seeded by
``SeedSequence([seed, step, host])``, so the batches equal the reference's
array for array; ``ShardedBatchIterator`` yields them as numpy arrays from
a background thread, and the launcher moves them to the card.  Across
devices the launcher builds the global batch on every rank (host 0 of 1,
as the reference's does) and each rank keeps its shard of it
(``train.sharding.make_batch_shardings``, ``place``).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_tokens: int = 0
    frontend_dim: int = 0


def batch_for_step(cfg: DataConfig, step: int, host: int = 0, n_hosts: int = 1):
    """Deterministic batch shard for (step, host): tokens + labels (+frontend)."""
    if cfg.global_batch % n_hosts:
        raise ValueError("global batch must divide across hosts")
    local = cfg.global_batch // n_hosts
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, host]))
    tokens = rng.integers(0, cfg.vocab, (local, cfg.seq_len), dtype=np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    out = {"tokens": tokens, "labels": labels}
    if cfg.frontend_tokens:
        out["frontend"] = rng.standard_normal(
            (local, cfg.frontend_tokens, cfg.frontend_dim), dtype=np.float32
        )
    return out


class ShardedBatchIterator:
    """Background-thread prefetching iterator over deterministic batches."""

    def __init__(self, cfg: DataConfig, host: int = 0, n_hosts: int = 1,
                 start_step: int = 0, prefetch: int = 2):
        self.cfg = cfg
        self.host = host
        self.n_hosts = n_hosts
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = batch_for_step(self.cfg, step, self.host, self.n_hosts)
            try:
                self._q.put((step, batch), timeout=1.0)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return step, batch

    def close(self):
        """Stop the worker and wait for it.  The queue is emptied first, so
        a worker blocked on a full queue puts at most one more batch and
        then sees the stop, rather than waiting out its 1 s timeout."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join()
