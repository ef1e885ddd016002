"""Least device time of one step, frozen so that the program cannot move it.

A copy of the bound arithmetic the port's chip smoke uses: each input
element a step needs read once and each output element written once at the
H100's HBM rate, against the step's operations at the data sheet's peak,
whichever is longer.  Both numbers are of the unpadded problem, so the
same work is counted whatever implements the step.
"""
from __future__ import annotations

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {8: 33.5e12, 4: 67e12}
# the D3Q15 step's operations a lattice site (the estimator's spec count)
LBM_FLOPS_PER_POINT = 180.0


def star_footprint(domain: tuple, r: int) -> int:
    """Elements of the halo-padded input that a range-r star over ``domain``
    reads: the domain box and r layers on each of its six faces."""
    Z, Y, X = domain
    return Z * Y * X + 2 * r * (Y * X + Z * X + Z * Y)


def _larger(t_bytes: float, t_ops: float) -> tuple:
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def star_bound(domain: tuple, r: int, elem_bytes: int) -> tuple:
    """(ms, limiter) of one range-r star stencil over ``domain``: its
    footprint read once and the output written once, against (6r+1)
    multiplies and 6r adds a point."""
    pts = domain[0] * domain[1] * domain[2]
    t_bytes = (star_footprint(domain, r) + pts) * elem_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (12 * r + 1) * pts / PEAK_FLOPS[elem_bytes] * 1e3
    return _larger(t_bytes, t_ops)


def lbm_bound(domain: tuple, elem_bytes: int) -> tuple:
    """(ms, limiter) of one D3Q15 step over ``domain``: 15 PDF boxes and
    the phase field's 7-point footprint read once, 15 PDFs written once,
    against 180 operations a site."""
    pts = domain[0] * domain[1] * domain[2]
    reads = 15 * pts + star_footprint(domain, 1)
    t_bytes = (reads + 15 * pts) * elem_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = LBM_FLOPS_PER_POINT * pts / PEAK_FLOPS[elem_bytes] * 1e3
    return _larger(t_bytes, t_ops)
