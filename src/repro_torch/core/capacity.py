"""Capacity-miss model (paper §4.5, eqs. 3-5, figs. 16/17/18).

The portion of the *redundant* data volume that still hits in a cache level is
modeled as a function of the oversubscription factor O = V_alloc / V_cache.
As in the paper we use a Gompertz sigmoid

    R_hit(O) = a * exp(-b * exp(-c * O))

(with c < 0 the function falls from ~a at O=0 towards 0 for large O).  The
function is "not grounded in any real-world mechanism" (paper) — it is a
smooth stand-in fitted against observed hit rates.  Where the paper fits
against hardware counters, the fits here were made against the LRU cache
simulator (``repro.core.cachesim``, which the port copies as
``repro_torch.core.cachesim``); `benchmarks/bench_capacity_fit.py`
regenerates them.

Separate fits are kept per level/volume class exactly as in the paper:
L1 redundant loads, L2 y-layer overlap, L2 z-layer overlap, L2 redundant
stores.

A copy of ``repro.core.capacity``: the scalar hit rate and its batched
(allocation x cache-size) form that the engine's machine-axis path reads.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


def gompertz(o: float, a: float, b: float, c: float) -> float:
    # guard overflow for strongly negative c * large O
    e = -c * o
    if e > 700:
        return 0.0
    return a * math.exp(-b * math.exp(e))


@dataclass(frozen=True)
class HitRateFit:
    a: float
    b: float
    c: float

    def __call__(self, oversubscription: float) -> float:
        return max(0.0, min(1.0, gompertz(oversubscription, self.a, self.b, self.c)))


# Default fits (regenerated by benchmarks/bench_capacity_fit.py against the
# LRU simulator; shapes chosen to mirror the paper's figures: the z-layer
# curve is "much tighter and steeper" (fig 17) than the y-layer one (fig 16),
# stores stay >90% for most points (fig 18)).
DEFAULT_FITS = {
    "l1_loads": HitRateFit(a=1.0, b=0.006, c=-1.6),
    "l2_over_y": HitRateFit(a=0.93, b=0.012, c=-1.1),
    "l2_over_z": HitRateFit(a=1.0, b=0.004, c=-2.4),
    "l2_store": HitRateFit(a=0.97, b=0.01, c=-0.9),
}


@dataclass
class CapacityModel:
    fits: dict = field(default_factory=lambda: dict(DEFAULT_FITS))

    def hit_rate(self, kind: str, v_alloc: float, v_cache: float) -> float:
        if v_cache <= 0:
            return 0.0
        o = v_alloc / v_cache
        return self.fits[kind](o)

    def hit_rate_matrix(self, kind: str, v_alloc, v_cache):
        """``hit_rate`` over the (allocation x cache-size) cross product.

        Returns a ``(len(v_alloc), len(v_cache))`` float64 array whose
        entries are **bitwise equal** to the scalar path: ``np.exp`` and
        ``math.exp`` disagree in the last ulp on some inputs, so the
        Gompertz curve is evaluated through the scalar ``hit_rate`` once
        per *unique* (allocation, cache) pair and broadcast by indexing.
        """
        import numpy as np

        va = np.asarray(v_alloc, dtype=float)
        vc = np.asarray(v_cache, dtype=float)
        ua, ia = np.unique(va, return_inverse=True)
        uc, ic = np.unique(vc, return_inverse=True)
        table = np.empty((ua.size, uc.size))
        for i, a in enumerate(ua):
            for j, c in enumerate(uc):
                table[i, j] = self.hit_rate(kind, float(a), float(c))
        return table[ia][:, ic]
