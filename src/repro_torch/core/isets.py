"""Implicit integer-set calculus — the ISL analogue of the paper (§4.4.1).

A copy of ``repro.core.isets``; the port keeps its own copy so that it never
imports the JAX package.

The paper uses the Integer Set Library to describe thread-coordinate sets and
memory-address sets implicitly, so that footprint counting does not scale with
the number of threads (~1e5 per wave).  We implement the subset of that
calculus actually required for address-expression footprints:

  * sets are finite unions of ``Box``es, a Box being a product of per-dimension
    arithmetic progressions ``APRange(start, step, n)``;
  * affine 1-D expressions ``floor((a*x + b) / q)`` with exact image
    computation for the cases that occur in dimension-aligned address
    expressions (a % q == 0, q % a == 0, a == 0), with an exact enumeration
    fallback for the rest;
  * exact union cardinality via recursive coordinate-compression sweep.

Everything here is exact — property tests compare against brute-force
enumeration (the paper's listing-5 grid iteration).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np


# --------------------------------------------------------------------------
# Arithmetic progressions
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class APRange:
    """{start + i*step : 0 <= i < n}; step >= 1."""

    start: int
    step: int
    n: int

    def __post_init__(self):
        if self.n < 0:
            raise ValueError("negative count")
        if self.step < 1:
            raise ValueError("step must be >= 1")

    @property
    def last(self) -> int:
        return self.start + (self.n - 1) * self.step

    @property
    def stop(self) -> int:  # exclusive bound on values
        return self.last + 1

    def is_empty(self) -> bool:
        return self.n == 0

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        return iter(range(self.start, self.start + self.n * self.step, self.step))

    def __contains__(self, v: int) -> bool:
        if v < self.start or v > self.last:
            return False
        return (v - self.start) % self.step == 0

    @staticmethod
    def interval(lo: int, hi: int) -> "APRange":
        """Contiguous [lo, hi] inclusive."""
        return APRange(lo, 1, max(0, hi - lo + 1))

    @staticmethod
    def point(v: int) -> "APRange":
        return APRange(v, 1, 1)


def _crt_intersect(r1: APRange, r2: APRange) -> APRange:
    """Exact intersection of two APs (CRT); result is an AP (possibly empty)."""
    if r1.is_empty() or r2.is_empty():
        return APRange(0, 1, 0)
    lo = max(r1.start, r2.start)
    hi = min(r1.last, r2.last)
    if lo > hi:
        return APRange(0, 1, 0)
    if r1.step == 1 and r2.step == 1:
        # contiguous intervals — the dominant case for address boxes
        return APRange(lo, 1, hi - lo + 1)
    g = math.gcd(r1.step, r2.step)
    if (r2.start - r1.start) % g != 0:
        return APRange(0, 1, 0)
    lcm = r1.step // g * r2.step
    # solve x ≡ r1.start (mod r1.step), x ≡ r2.start (mod r2.step)
    # via extended gcd
    _, p, _ = _egcd(r1.step // g, r2.step // g)
    diff = (r2.start - r1.start) // g
    k = (diff * p) % (r2.step // g)
    x0 = r1.start + k * r1.step
    # smallest solution >= lo
    if x0 < lo:
        x0 += ((lo - x0 + lcm - 1) // lcm) * lcm
    if x0 > hi:
        return APRange(0, 1, 0)
    n = (hi - x0) // lcm + 1
    return APRange(x0, lcm, n)


def _egcd(a: int, b: int):
    if b == 0:
        return a, 1, 0
    g, x, y = _egcd(b, a % b)
    return g, y, x - (a // b) * y


# --------------------------------------------------------------------------
# Boxes and sets
# --------------------------------------------------------------------------
Box = tuple  # tuple[APRange, ...]


def box(*ranges: APRange) -> Box:
    return tuple(ranges)


def box_interval(*bounds: tuple) -> Box:
    """box_interval((lo,hi), (lo,hi), ...) — contiguous box, inclusive bounds."""
    return tuple(APRange.interval(lo, hi) for lo, hi in bounds)


def box_is_empty(b: Box) -> bool:
    return any(r.is_empty() for r in b)


def box_count(b: Box) -> int:
    return math.prod(r.n for r in b)


def box_intersect(a: Box, b: Box) -> Box:
    if len(a) != len(b):
        raise ValueError("dim mismatch")
    return tuple(_crt_intersect(ra, rb) for ra, rb in zip(a, b))


def box_points(b: Box) -> Iterable[tuple]:
    """Explicit enumeration (for oracles / small boxes)."""
    if box_is_empty(b):
        return
    from itertools import product

    yield from product(*[list(r) for r in b])


def _expand_strided(boxes: Sequence[Box], limit: int = 1 << 22) -> list[Box]:
    """Rewrite strided dims as unions of unit boxes when exact sweep needs it.

    Strided dims with large n are kept as-is when they cannot overlap others
    incompatibly; the sweep below handles step>1 only by expansion, so we
    expand, guarded by a work limit.
    """
    out = []
    budget = limit
    for b in boxes:
        exp = [b]
        for d, r in enumerate(b):
            if r.step == 1 or r.n <= 1:
                continue
            new = []
            for bb in exp:
                rr = bb[d]
                budget -= rr.n
                if budget < 0:
                    raise RuntimeError("strided expansion limit exceeded")
                for v in rr:
                    new.append(bb[:d] + (APRange.point(v),) + bb[d + 1:])
            exp = new
        out.extend(exp)
    return out


def count_union(boxes: Sequence[Box]) -> int:
    """Exact |union of boxes| via recursive coordinate-compression sweep."""
    boxes = [b for b in boxes if not box_is_empty(b)]
    if not boxes:
        return 0
    ndim = len(boxes[0])
    if any(len(b) != ndim for b in boxes):
        raise ValueError("dim mismatch")
    # normalize strides (rare path)
    if any(r.step != 1 and r.n > 1 for b in boxes for r in b):
        boxes = _expand_strided(boxes)
    # duplicates cannot change a union; dropping them up front keeps the
    # sweep's pairwise work quadratic in *distinct* boxes only
    return _count_union_unit(list(dict.fromkeys(boxes)), {})


# --------------------------------------------------------------------------
# Array fast path for intersections (bitwise-identical counts)
# --------------------------------------------------------------------------
# The wave-model overlaps intersect box lists pairwise — O(|a|*|b|) Python
# ``box_intersect``/``APRange`` object churn dominated cold exact-tier
# pricing.  For unit-step boxes (every address box the dimension-aligned
# expressions produce, bar the rare strided image) the same exact integer
# counts come out of plain (start, end) int64 arrays: pairwise intersection
# is a broadcast max/min and de-duplication is ``np.unique`` on rows; the
# few hundred surviving distinct boxes then go through the exact recursive
# union sweep as before.  Any strided range opts the caller back into the
# object path — correctness never depends on the fast path.

def _unit_boxes_to_array(boxes: Sequence[Box]):
    """(n, 2d) int64 array [starts | ends] for unit-step boxes, else None."""
    if not boxes:
        return None
    vals = []
    for b in boxes:
        row = []
        for r in b:
            if r.step != 1 and r.n > 1:
                return None
            row.append(r.start)
        for r in b:
            row.append(r.last)
        vals.append(row)
    return np.asarray(vals, dtype=np.int64)


def _array_to_unit_boxes(arr: np.ndarray) -> list[Box]:
    d = arr.shape[1] // 2
    return [
        tuple(APRange.interval(int(row[k]), int(row[d + k])) for k in range(d))
        for row in arr
    ]


def _intersect_unit_arrays(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise-intersection rows of two [starts | ends] arrays (deduped)."""
    d = a.shape[1] // 2
    s = np.maximum(a[:, None, :d], b[None, :, :d])
    e = np.minimum(a[:, None, d:], b[None, :, d:])
    valid = (s <= e).all(axis=-1).ravel()
    rows = np.concatenate([s.reshape(-1, d), e.reshape(-1, d)], axis=1)[valid]
    if not len(rows):
        return rows
    return np.unique(rows, axis=0)


def count_triple_overlap(a: Sequence[Box], b: Sequence[Box],
                         c: Sequence[Box]) -> int:
    """|(∪a) ∩ (∪b) ∩ (∪c)| exactly (the wave ∩ z ∩ y correction)."""
    if not (a and b and c):
        return 0
    aa, ab, ac = (_unit_boxes_to_array(x) for x in (a, b, c))
    if aa is None or ab is None or ac is None:
        inter = []
        for ba in a:
            for bb in b:
                ib = box_intersect(ba, bb)
                if not box_is_empty(ib):
                    inter.append(ib)
        return count_intersection_of_unions(inter, list(c)) if inter else 0
    rows = _intersect_unit_arrays(aa, ab)
    if len(rows):
        rows = _intersect_unit_arrays(rows, ac)
    if not len(rows):
        return 0
    return _count_union_unit(_array_to_unit_boxes(rows), {})


def _count_union_unit(boxes: list[Box], memo: dict | None = None) -> int:
    if memo is None:
        memo = {}
    ndim = len(boxes[0])
    if ndim == 1:
        ivals = sorted((b[0].start, b[0].last) for b in boxes)
        total = 0
        cur_lo, cur_hi = ivals[0]
        for lo, hi in ivals[1:]:
            if lo > cur_hi + 1:
                total += cur_hi - cur_lo + 1
                cur_lo, cur_hi = lo, hi
            else:
                cur_hi = max(cur_hi, hi)
        total += cur_hi - cur_lo + 1
        return total
    # coordinate-compress dim 0
    cuts = sorted({b[0].start for b in boxes} | {b[0].last + 1 for b in boxes})
    total = 0
    for i in range(len(cuts) - 1):
        lo, hi = cuts[i], cuts[i + 1] - 1
        covering = [b[1:] for b in boxes if b[0].start <= lo and b[0].last >= hi]
        if covering:
            # adjacent slabs are often covered by the same sub-boxes; the
            # per-call memo (set-keyed: union is order/multiplicity-blind)
            # collapses those repeated sub-sweeps
            key = frozenset(covering)
            sub = memo.get(key)
            if sub is None:
                memo[key] = sub = _count_union_unit(
                    list(dict.fromkeys(covering)), memo)
            total += (hi - lo + 1) * sub
    return total


def count_intersection_of_unions(a: Sequence[Box], b: Sequence[Box]) -> int:
    """|(∪a) ∩ (∪b)| exactly: intersect pairwise then count union."""
    if not a or not b:
        return 0
    aa, ab = _unit_boxes_to_array(a), _unit_boxes_to_array(b)
    if aa is not None and ab is not None:
        rows = _intersect_unit_arrays(aa, ab)
        if not len(rows):
            return 0
        return _count_union_unit(_array_to_unit_boxes(rows), {})
    inter = []
    for ba in a:
        for bb in b:
            ib = box_intersect(ba, bb)
            if not box_is_empty(ib):
                inter.append(ib)
    return count_union(inter)


# --------------------------------------------------------------------------
# Affine 1-D expressions with floor division:  floor((a*x + b) / q)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class AffineExpr1D:
    """y = floor((a*x + b) / q) over a single input coordinate x."""

    a: int
    b: int
    q: int = 1

    def __post_init__(self):
        if self.q < 1:
            raise ValueError("divisor must be >= 1")

    def __call__(self, x: int) -> int:
        return (self.a * x + self.b) // self.q

    def image(self, r: APRange) -> list[APRange]:
        """Exact image of an APRange under this expression."""
        if r.is_empty():
            return []
        a, b, q = self.a, self.b, self.q
        if a == 0 or r.n == 1:
            return [APRange.point((a * r.start + b) // q)]
        eff = a * r.step  # increment of (a*x+b) per element of r
        if eff % q == 0:
            # uniform stride in the image
            step = eff // q
            start = (a * r.start + b) // q
            if step > 0:
                return [APRange(start, step, r.n)]
            if step < 0:
                return [APRange(start + (r.n - 1) * step, -step, r.n)]
            return [APRange.point(start)]
        if 0 < eff < q or -q < eff < 0:
            # image is a contiguous interval, every integer in range hit
            v0 = (a * r.start + b) // q
            v1 = (a * r.last + b) // q
            return [APRange.interval(min(v0, v1), max(v0, v1))]
        # general fallback: exact enumeration, coalesced
        vals = sorted({(a * x + b) // q for x in r})
        return _coalesce_points(vals)


def _coalesce_points(vals: list[int]) -> list[APRange]:
    """Merge sorted distinct ints into maximal contiguous APRanges."""
    out = []
    i = 0
    while i < len(vals):
        j = i
        while j + 1 < len(vals) and vals[j + 1] == vals[j] + 1:
            j += 1
        out.append(APRange.interval(vals[i], vals[j]))
        i = j + 1
    return out


def map_box(exprs: Sequence[tuple[int, "AffineExpr1D"]], src: Box) -> list[Box]:
    """Image of a Box under a separable multi-dim affine map.

    ``exprs`` is a list of (input_dim, AffineExpr1D) — output dim j reads input
    coordinate ``input_dim[j]``.  Because each output dim depends on exactly one
    input dim (the paper's multi-dimensional address space, §4.4.1), the image
    of a box is a union of boxes, computed as the per-dim image product.

    If two output dims read the same input dim the result is an
    over-approximation in general; our address expressions never do that.
    """
    per_dim: list[list[APRange]] = []
    for dim_idx, e in exprs:
        per_dim.append(e.image(src[dim_idx]))
    # cartesian product of per-dim alternative ranges
    from itertools import product

    return [tuple(combo) for combo in product(*per_dim)]
