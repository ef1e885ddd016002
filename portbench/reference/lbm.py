"""One D3Q15 interface-tracking step (arXiv:2204.14242 §5.3), plain PyTorch.

Pull scheme: PDF q at a site comes from its upstream neighbour (site - c_q);
the phase field's gradient is taken by central differences; each PDF
relaxes with time ``tau`` toward w_q·φ + w_q·κφ(1-φ)·(c_q·n), n the unit
normal ∇φ/|∇φ|.  Every point outside the domain reads 0.  Returns the new
PDFs and their sum over q, the phase field of the next step.
"""
from __future__ import annotations

import torch

VELOCITIES = (
    (0, 0, 0),
    (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1),
    (1, 1, 1), (-1, -1, -1), (1, 1, -1), (-1, -1, 1),
    (1, -1, 1), (-1, 1, -1), (-1, 1, 1), (1, -1, -1),
)   # (cx, cy, cz)
WEIGHTS = (2 / 9,) + (1 / 9,) * 6 + (1 / 72,) * 8
BLOCK_PLANES = 32   # output z planes a block


def equilibrium(phase: torch.Tensor) -> torch.Tensor:
    """The (15, Z, Y, X) PDFs at rest for ``phase``: w_q·φ."""
    w = torch.tensor(WEIGHTS, dtype=phase.dtype, device=phase.device)
    return w.view(15, 1, 1, 1) * phase


def _block(pdf_p: torch.Tensor, phase_p: torch.Tensor, tau: float, kappa: float) -> tuple:
    """Outputs of a block from its halo-1 padded PDFs and phase field."""
    _q, zp, yp, xp = pdf_p.shape
    Z, Y, X = zp - 2, yp - 2, xp - 2

    def at(a, dz, dy, dx):
        return a[1 + dz:1 + dz + Z, 1 + dy:1 + dy + Y, 1 + dx:1 + dx + X]

    phi = at(phase_p, 0, 0, 0)
    gx = 0.5 * (at(phase_p, 0, 0, 1) - at(phase_p, 0, 0, -1))
    gy = 0.5 * (at(phase_p, 0, 1, 0) - at(phase_p, 0, -1, 0))
    gz = 0.5 * (at(phase_p, 1, 0, 0) - at(phase_p, -1, 0, 0))
    inv = torch.rsqrt(gx * gx + gy * gy + gz * gz + 1e-12)
    sharp = kappa * phi * (1.0 - phi)
    new = torch.empty((15, Z, Y, X), dtype=pdf_p.dtype, device=pdf_p.device)
    for q, (cx, cy, cz) in enumerate(VELOCITIES):
        w = WEIGHTS[q]
        h = at(pdf_p[q], -cz, -cy, -cx)
        cdotn = (cx * gx + cy * gy + cz * gz) * inv
        heq = w * phi + w * sharp * cdotn
        new[q] = h - (h - heq) / tau
    return new, new.sum(0)


def step(pdf: torch.Tensor, phase: torch.Tensor, tau: float, kappa: float,
         dtype=None) -> tuple:
    """One step of (15, Z, Y, X) PDFs and the (Z, Y, X) phase field, computed
    in ``dtype`` (the fields' own by default), returned in their dtype."""
    dtype = dtype or pdf.dtype
    new_pdf = torch.empty_like(pdf)
    new_phase = torch.empty_like(phase)
    Z = phase.shape[0]
    pad = torch.nn.functional.pad
    for z0 in range(0, Z, BLOCK_PLANES):
        z1 = min(Z, z0 + BLOCK_PLANES)
        lo, hi = max(0, z0 - 1), min(Z, z1 + 1)
        zpad = (1, 1, 1, 1, 1 - (z0 - lo), 1 - (hi - z1))
        got, s = _block(pad(pdf[:, lo:hi].to(dtype), zpad), pad(phase[lo:hi].to(dtype), zpad),
                        tau, kappa)
        new_pdf[:, z0:z1] = got.to(pdf.dtype)
        new_phase[z0:z1] = s.to(phase.dtype)
    return new_pdf, new_phase
