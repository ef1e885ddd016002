"""Kernel access-specs for the paper's applications.

These are the "address expressions + field sizes" artifacts a code generator
hands to the estimator (paper §1.2).  A copy of the specs of
``repro.core.specs`` (the star stencil, the 2D 5-point stencil, the
D3Q15 LBM, the naive GEMM, and the streaming LOAD and SCALE kernels the
cache simulator's tests drive) that the port's generators price, and the
transpose's spec, which the reference gets only by tracing; the per-point
CUDA kernels in ``repro_torch/csrc`` perform exactly these accesses.  The
GEMM spec is the suite's CUDA-core price of a model's matmuls; the tiled
tensor-core GEMM (``csrc/matmul.cu``) is not that kernel.
"""
from __future__ import annotations

from .access import Access, Field, KernelSpec


def star_stencil_3d(
    r: int = 4, domain=(512, 512, 640), elem_bytes: int = 8, name: str | None = None
) -> KernelSpec:
    """Range-r 3D star stencil (paper §5.2: r=4 -> 25-point).

    dst[z,y,x] = w * sum of src at +-1..r along each axis + center.
    Flops: 25 for the paper's stencil (24 adds + 1 mul equivalent mix).
    """
    dz, dy, dx = domain
    # halo-padded source so offsets stay in bounds; alignment 0
    src = Field("src", (dz + 2 * r, dy + 2 * r, dx + 2 * r), elem_bytes)
    dst = Field("dst", (dz, dy, dx), elem_bytes)
    accs = [Access(src, (r + 0, r + 0, r + 0))]  # center
    for d in range(3):
        for o in range(1, r + 1):
            for s in (-o, o):
                off = [r, r, r]
                off[d] += s
                accs.append(Access(src, tuple(off)))
    accs.append(Access(dst, (0, 0, 0), is_store=True))
    n_pts = 6 * r + 1
    return KernelSpec(
        name=name or f"star3d_r{r}",
        domain=domain,
        accesses=tuple(accs),
        flops_per_point=float(n_pts),
    )


def stencil_2d5pt(domain=(4096, 4096), elem_bytes: int = 8) -> KernelSpec:
    """2D 5-point stencil (paper figs. 6/7/9 illustrations)."""
    dy, dx = domain
    src = Field("src", (dy + 2, dx + 2), elem_bytes)
    dst = Field("dst", (dy, dx), elem_bytes)
    accs = [
        Access(src, (1, 1)),
        Access(src, (0, 1)),
        Access(src, (2, 1)),
        Access(src, (1, 0)),
        Access(src, (1, 2)),
        Access(dst, (0, 0), is_store=True),
    ]
    return KernelSpec("stencil2d5pt", domain, tuple(accs), flops_per_point=5.0)


def transpose_pad(shape, elem_bytes: int = 4) -> KernelSpec:
    """Per-point transpose of an (M, N) operand ``x`` into (N, M) ``xt``:
    over the domain (N, M), point (y, x) loads ``x[x, y]`` (``dim_map``
    (1, 0)) and stores ``xt[y, x]``; no arithmetic.

    Written by hand because the reference has this spec only as the GPU
    lowering of its traced Pallas kernel
    (``repro.kernels.transpose_pad.generator.traced_gpu_spec``), and its
    tracer is broken on jax 0.9.0.  It covers the unpadded operand: the
    Pallas kernel needs whole (bm, bn) tiles, the guarded CUDA kernel no
    padding.  At tile multiples it equals the reference's traced spec.
    """
    M, N = shape
    x = Field("x", (M, N), elem_bytes)
    xt = Field("xt", (N, M), elem_bytes)
    accs = (
        Access(x, (0, 0), dim_map=(1, 0)),
        Access(xt, (0, 0), is_store=True),
    )
    return KernelSpec("transpose_pad", (N, M), accs, flops_per_point=0.0)


# D3Q15 lattice velocities (c_q), the conventional ordering
D3Q15_VELOCITIES = (
    (0, 0, 0),
    (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1),
    (1, 1, 1), (-1, -1, -1), (1, 1, -1), (-1, -1, 1),
    (1, -1, 1), (-1, 1, -1), (-1, 1, 1), (1, -1, -1),
)

# 3D7pt offsets for the phase-field finite-difference curvature stencil
D3Q7_OFFSETS = ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))


def lbm_d3q15(domain=(256, 256, 256), elem_bytes: int = 8) -> KernelSpec:
    """Allen-Cahn interface-tracking LBM kernel access pattern (paper §5.3).

    Pull scheme: 15 PDF loads from neighbor cells (unaligned), 15 aligned PDF
    stores, plus a 3D 7-point finite-difference stencil on the phase field.
    PDFs are stored structure-of-arrays: pdf[q][z][y][x].
    240 B/LUP streaming + 16-64 B/LUP stencil component (paper).
    """
    dz, dy, dx = domain
    pad = 1
    src = Field("pdf_src", (15, dz + 2 * pad, dy + 2 * pad, dx + 2 * pad), elem_bytes)
    dst = Field("pdf_dst", (15, dz, dy, dx), elem_bytes)
    phi = Field("phase", (dz + 2 * pad, dy + 2 * pad, dx + 2 * pad), elem_bytes)
    accs = []
    for q, (cx, cy, cz) in enumerate(D3Q15_VELOCITIES):
        # pull: load PDF q from the upstream neighbor (-c)
        accs.append(
            Access(
                src,
                (q, pad - cz, pad - cy, pad - cx),
                coeffs=(0, 1, 1, 1),
                dim_map=(0, 0, 1, 2),
            )
        )
        accs.append(
            Access(dst, (q, 0, 0, 0), coeffs=(0, 1, 1, 1), dim_map=(0, 0, 1, 2), is_store=True)
        )
    for (ox, oy, oz) in D3Q7_OFFSETS:
        accs.append(Access(phi, (pad + oz, pad + oy, pad + ox)))
    # LBM collide+stream flop estimate for Allen-Cahn interface tracking
    return KernelSpec("lbm_d3q15", domain, tuple(accs), flops_per_point=180.0)


def matmul_naive(M: int, K: int, N: int, elem_bytes: int = 2,
                 name: str | None = None) -> KernelSpec:
    """C[m,n] += A[m,k] * B[k,n] as address expressions (blocked linear
    algebra on the paper's model).

    The iteration domain is one point per multiply-accumulate, in (z,y,x) =
    (k, m, n) order: a thread block covers an (bm x bn) output tile and a bk
    slice of the reduction, so block/folding shapes trade A-row reuse
    (along x), B-column reuse (along y), and C-tile residency (along z) —
    the same locality space a tiled CUDA-core GEMM explores.  The store's
    address ignores the k dimension (coeff via dim_map), exactly like the
    LBM spec's per-PDF dimension folding.  Work unit: 1 MAC = 2 flops;
    ``perf_lups`` is MAC/s.
    """
    a = Field("A", (M, K), elem_bytes)
    b = Field("B", (K, N), elem_bytes)
    c = Field("C", (M, N), elem_bytes)
    accs = (
        Access(a, (0, 0), dim_map=(1, 0)),            # A[m, k]
        Access(b, (0, 0), dim_map=(0, 2)),            # B[k, n]
        Access(c, (0, 0), dim_map=(1, 2), is_store=True),  # C[m, n]
    )
    return KernelSpec(
        name or f"gemm_{M}x{K}x{N}", (K, M, N), accs,
        flops_per_point=2.0, work_unit="MAC",
    )


def streaming_load(n: int, elem_bytes: int = 8) -> KernelSpec:
    """c = A[i]  (paper fig. 2 LOAD kernel)."""
    a = Field("A", (n,), elem_bytes)
    return KernelSpec("load", (n,), (Access(a, (0,)),), flops_per_point=0.0)


def streaming_scale(n: int, elem_bytes: int = 8) -> KernelSpec:
    """A[i] = c * B[i]  (paper figs. 2/3 SCALE kernel)."""
    a = Field("A", (n,), elem_bytes)
    b = Field("B", (n,), elem_bytes)
    return KernelSpec(
        "scale", (n,), (Access(b, (0,)), Access(a, (0,), is_store=True)), flops_per_point=1.0
    )
