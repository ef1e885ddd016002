"""Plain PyTorch version of the D3Q15 Allen-Cahn interface-tracking LBM step
(paper §5.3).

The counterpart of ``repro.kernels.lbm_d3q15.ref``.  The step pulls 15 PDFs
from their upstream neighbours, takes the phase-field gradient by central
differences (a 3D 7-point stencil), and relaxes each PDF toward an
equilibrium with an interface-sharpening flux along the interface normal.
The CPU tests run it, and the CUDA kernels are held against it on the card;
nothing on the card's main path calls it.
"""
from __future__ import annotations

import torch

from repro_torch.core.specs import D3Q15_VELOCITIES

VELOCITIES = D3Q15_VELOCITIES
WEIGHTS = (2 / 9,) + (1 / 9,) * 6 + (1 / 72,) * 8


def lbm_step_ref(pdf_padded: torch.Tensor, phase_padded: torch.Tensor,
                 tau: float = 0.8, kappa: float = 0.15) -> tuple:
    """One interface-tracking step.

    pdf_padded:   (15, Z+2, Y+2, X+2) — halo-1 padded PDFs
    phase_padded: (Z+2, Y+2, X+2)     — halo-1 padded phase field
    Returns (pdf_new (15, Z, Y, X), phase_new (Z, Y, X)).  Python scalars
    (weights, tau, kappa, 1e-12) are rounded to the fields' dtype before
    they multiply, as JAX's weak typing does.
    """
    _q, zp, yp, xp = pdf_padded.shape
    Z, Y, X = zp - 2, yp - 2, xp - 2

    def ip(a, dz, dy, dx):  # interior slice with offset
        return a[1 + dz : 1 + dz + Z, 1 + dy : 1 + dy + Y, 1 + dx : 1 + dx + X]

    phi = ip(phase_padded, 0, 0, 0)
    gx = 0.5 * (ip(phase_padded, 0, 0, 1) - ip(phase_padded, 0, 0, -1))
    gy = 0.5 * (ip(phase_padded, 0, 1, 0) - ip(phase_padded, 0, -1, 0))
    gz = 0.5 * (ip(phase_padded, 1, 0, 0) - ip(phase_padded, -1, 0, 0))
    inv = torch.rsqrt(gx * gx + gy * gy + gz * gz + 1e-12)
    sharp = kappa * phi * (1.0 - phi)

    new = []
    phase_new = 0.0
    for qi, (cx, cy, cz) in enumerate(VELOCITIES):
        w = WEIGHTS[qi]
        # pull: PDF qi streamed from cell - c
        h = ip(pdf_padded[qi], -cz, -cy, -cx)
        cdotn = (cx * gx + cy * gy + cz * gz) * inv
        heq = w * phi + w * sharp * cdotn
        hnew = h - (h - heq) / tau
        new.append(hnew)
        phase_new = phase_new + hnew
    return torch.stack(new), phase_new


def pad_inputs(pdf: torch.Tensor, phase: torch.Tensor) -> tuple:
    """Zero halo of width 1 around the (15, Z, Y, X) PDFs' spatial axes and
    the (Z, Y, X) phase field."""
    pad = torch.nn.functional.pad
    return pad(pdf, (1, 1, 1, 1, 1, 1)), pad(phase, (1, 1, 1, 1, 1, 1))
