"""Kernel access-specs for the paper's applications.

These are the "address expressions + field sizes" artifacts a code generator
hands to the estimator (paper §1.2).  A copy of the specs of
``repro.core.specs`` that the port's generators price; the per-point CUDA
kernels in ``repro_torch/csrc`` perform exactly these accesses.
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
