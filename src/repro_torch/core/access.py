"""Address expressions and kernel access specifications (paper §1.2, §4).

The single artifact the estimator requires from a code generator is the set of
*address expressions*: per memory access, an affine map from thread/grid
coordinates to referenced addresses, plus the launch configuration, field
sizes and alignments (paper §1.2).

We use the paper's multi-dimensional address space (§4.4.1): an address is a
tuple ``(..., ay, ax)`` where only the innermost (x) component carries the
floor-division by the cache-line/sector size.  Two addresses are distinct iff
the tuples differ — exact up to row wrap-around, which the paper shows is
negligible for realistic grids.

A copy of ``repro.core.access`` trimmed to what ``estimate_gpu`` reaches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from .isets import AffineExpr1D, APRange, Box, map_box


def domain_zyx(domain) -> tuple:
    """Normalize a 1-3D iteration-domain tuple to padded (dz, dy, dx).

    The kernel domain convention is (..., Y, X) with missing leading dims
    of extent 1; every consumer (grid shapes, thread clipping, wave sets,
    cache-simulator scheduling) shares this one normalization.
    """
    if len(domain) == 3:
        return (domain[0], domain[1], domain[2])
    if len(domain) == 2:
        return (1, domain[0], domain[1])
    if len(domain) == 1:
        return (1, 1, domain[0])
    raise ValueError("domain must be 1-3 dims")


def memoize_hash(cls):
    """Cache a frozen dataclass's hash on the instance.

    Engine cache keys embed whole ``KernelSpec`` trees; Python recomputes a
    dataclass hash from scratch on *every* dict probe, which made key
    hashing the dominant cost of warm exploration sweeps.  The memo is
    stripped from the pickled state — ``hash()`` is process-seeded
    (PYTHONHASHSEED), so a persisted memo would poison dict lookups in the
    next process.
    """
    base_hash = cls.__hash__

    def __hash__(self):
        h = self.__dict__.get("_hashcache")
        if h is None:
            h = base_hash(self)
            object.__setattr__(self, "_hashcache", h)
        return h

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_hashcache", None)
        return state

    cls.__hash__ = __hash__
    cls.__getstate__ = __getstate__
    return cls


@memoize_hash
@dataclass(frozen=True)
class Field:
    """A multi-dimensional array operand.

    shape is (..., ny, nx) with x innermost / contiguous.  ``alignment`` is the
    element offset of the base pointer modulo the cache line (the paper
    replaces the unknown base pointer with the field's alignment).
    """

    name: str
    shape: tuple
    elem_bytes: int = 8
    alignment: int = 0  # in elements, shift of base vs line boundary

    @property
    def ndim(self) -> int:
        return len(self.shape)


@memoize_hash
@dataclass(frozen=True)
class Access:
    """One load/store: domain coordinate -> element coordinate per dim.

    For dimension-aligned accesses (stencils, LBM, blocked linear algebra) the
    element coordinate in field dim j is ``coeff[j] * p[dim_map[j]] +
    offset[j]`` where p is the domain point computed by a thread.
    """

    field: Field
    offsets: tuple            # per field dim
    coeffs: tuple = None      # per field dim, default all 1
    dim_map: tuple = None     # field dim -> domain dim, default identity
    is_store: bool = False

    def __post_init__(self):
        nd = self.field.ndim
        if self.coeffs is None:
            object.__setattr__(self, "coeffs", (1,) * nd)
        if self.dim_map is None:
            object.__setattr__(self, "dim_map", tuple(range(nd)))
        if not (len(self.offsets) == len(self.coeffs) == len(self.dim_map) == nd):
            raise ValueError("access arity mismatch with field ndim")

    def line_exprs(self, line_bytes: int) -> list:
        """Multi-dim address expressions with innermost floor-div (§4.4.1).

        Returns [(domain_dim, AffineExpr1D), ...] — one per field dim; the
        innermost dim divides by the line size in elements (alignment folded
        into the numerator, in bytes for exactness with elem_bytes).
        """
        eb = self.field.elem_bytes
        exprs = []
        nd = self.field.ndim
        for j in range(nd):
            if j == nd - 1:
                # floor((eb*(c*x + o + align)) / line_bytes)
                exprs.append(
                    (
                        self.dim_map[j],
                        AffineExpr1D(
                            a=eb * self.coeffs[j],
                            b=eb * (self.offsets[j] + self.field.alignment),
                            q=line_bytes,
                        ),
                    )
                )
            else:
                exprs.append(
                    (self.dim_map[j], AffineExpr1D(a=self.coeffs[j], b=self.offsets[j]))
                )
        return exprs

    def line_boxes(self, domain_boxes: Sequence[Box], line_bytes: int) -> list[Box]:
        """Image of a set of domain boxes in line-granular address space."""
        exprs = self.line_exprs(line_bytes)
        out = []
        for b in domain_boxes:
            out.extend(map_box(exprs, b))
        return out


@memoize_hash
@dataclass(frozen=True)
class KernelSpec:
    """Everything the estimator needs about a kernel (paper fig. 1 inputs)."""

    name: str
    domain: tuple                 # iteration domain extents (..., Y, X) order (z,y,x)
    accesses: tuple               # tuple[Access, ...]
    flops_per_point: float = 0.0
    work_unit: str = "LUP"

    @property
    def loads(self):
        return tuple(a for a in self.accesses if not a.is_store)

    @property
    def stores(self):
        return tuple(a for a in self.accesses if a.is_store)


@memoize_hash
@dataclass(frozen=True)
class LaunchConfig:
    """GPU launch configuration: thread block shape + thread folding.

    ``block`` is (bx, by, bz) threads; ``folding`` (fx, fy, fz) consecutive
    domain points computed per thread in each dim (paper's thread folding).
    Domain order in KernelSpec is (z, y, x); block/folding are (x, y, z) as in
    the paper's notation.
    """

    block: tuple = (256, 1, 1)
    folding: tuple = (1, 1, 1)

    @property
    def threads(self) -> int:
        x, y, z = self.block
        return x * y * z

    def points_per_block(self) -> int:
        return self.threads * self.folding[0] * self.folding[1] * self.folding[2]

    def block_extent(self) -> tuple:
        """Domain extent covered by one thread block, (x, y, z)."""
        return tuple(b * f for b, f in zip(self.block, self.folding))

    def grid_for(self, domain: tuple) -> tuple:
        """Thread-block grid (gx, gy, gz) for domain (z, y, x)."""
        ext = self.block_extent()
        dz, dy, dx = domain_zyx(domain)
        gx = -(-dx // ext[0])
        gy = -(-dy // ext[1])
        gz = -(-dz // ext[2])
        return (gx, gy, gz)

    # ---- thread-group domain boxes -------------------------------------
    def block_domain_boxes(self, block_idx: tuple, domain: tuple) -> list[Box]:
        """Domain points (z,y,x boxes) covered by thread block ``block_idx``.

        Clipped to the valid domain (the ``if (tid >= N) return;`` pattern is
        an intersection with the valid-domain set, paper §4.4.1).
        """
        ex, ey, ez = self.block_extent()
        bx, by, bz = block_idx
        dz, dy, dx = domain_zyx(domain)
        x0, x1 = bx * ex, min((bx + 1) * ex, dx) - 1
        y0, y1 = by * ey, min((by + 1) * ey, dy) - 1
        z0, z1 = bz * ez, min((bz + 1) * ez, dz) - 1
        if x0 > x1 or y0 > y1 or z0 > z1:
            return []
        b3 = (APRange.interval(z0, z1), APRange.interval(y0, y1), APRange.interval(x0, x1))
        if len(domain) == 3:
            return [b3]
        if len(domain) == 2:
            return [b3[1:]]
        return [b3[2:]]
