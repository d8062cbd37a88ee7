"""Kepler-equation solver: fixed-depth Newton with the implicit
derivative (pint_tpu models/binary/kepler.py).

The depth is a host-chosen static int (:func:`newton_iters_for`); the
forward-mode tangent comes from the implicit function theorem,
dE = (dM + sinE de) / (1 - e cosE), so autodiff never differentiates
through the iteration loop.
"""

from __future__ import annotations

import torch

#: Newton iterations for e <~ 0.97
_NEWTON_ITERS = 10


def newton_iters_for(ecc_max: float) -> int:
    """Newton depth sufficient for eccentricities up to ``ecc_max``
    (two spare quadratic iterations beyond the proven bound)."""
    e = float(ecc_max)
    if not (e == e) or e < 0:  # NaN (unset ECC) -> full depth
        return _NEWTON_ITERS
    if e < 0.05:
        return 4
    if e < 0.25:
        return 6
    if e < 0.6:
        return 8
    return _NEWTON_ITERS


def _solve(mean_anom, ecc, iters):
    E = mean_anom + ecc * torch.sin(mean_anom)
    for _ in range(iters):
        f = E - ecc * torch.sin(E) - mean_anom
        fp = 1.0 - ecc * torch.cos(E)
        E = E - f / fp
    return E


class _Kepler(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(mean_anom, ecc, iters):
        return _solve(mean_anom, ecc, iters)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ecc, _ = inputs
        ctx.save_for_forward(ecc, output)

    @staticmethod
    def jvp(ctx, dm, de, _diters):
        ecc, E = ctx.saved_tensors
        num = torch.zeros_like(E)
        if dm is not None:
            num = num + dm
        if de is not None:
            num = num + torch.sin(E) * de
        return num / (1.0 - ecc * torch.cos(E))


def kepler_eccentric_anomaly(mean_anom, ecc, iters=_NEWTON_ITERS):
    """Solve E - e sinE = M elementwise at a static Newton depth."""
    return _Kepler.apply(mean_anom, ecc, int(iters))


def true_anomaly(E, ecc):
    """True anomaly, continuous with E (atan2 half-angle form)."""
    half = 0.5 * E
    nu_half = torch.atan2(
        torch.sqrt(1.0 + ecc) * torch.sin(half),
        torch.sqrt(1.0 - ecc) * torch.cos(half))
    return 2.0 * nu_half
