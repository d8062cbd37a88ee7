"""Pulsation test statistics: Z^2_m, H-test, sigma conversions (the
port's own copy of ``pint_tpu.eventstats``, host numpy).

Counterpart of the reference eventstats module (reference:
src/pint/eventstats.py:1-346 ``z2m``/``hm``/``sf_*``): Rayleigh-family
statistics on photon phases, with optional weights (Kerr 2011).
Significance of the H-test follows de Jager & Buesching (2010):
sf = exp(-0.398405 H).
"""

from __future__ import annotations

import numpy as np

__all__ = ["z2m", "hm", "hmw", "sf_z2m", "sf_hm", "sig2sigma",
           "sigma2sig"]


def z2m(phases, m=2, weights=None):
    """Z^2_m statistics for harmonics 1..m; returns an array of the
    cumulative statistic at each m (reference eventstats.z2m)."""
    phases = np.asarray(phases, dtype=np.float64)
    w = np.ones_like(phases) if weights is None else np.asarray(weights)
    norm = np.sum(w**2)
    ks = np.arange(1, m + 1)
    arg = 2.0 * np.pi * np.outer(ks, phases)
    c = (np.cos(arg) * w).sum(axis=1)
    s = (np.sin(arg) * w).sum(axis=1)
    return 2.0 / norm * np.cumsum(c**2 + s**2)


def hm(phases, m=20):
    """H-test statistic (de Jager, Raubenheimer & Swanepoel 1989):
    max over m of Z^2_m - 4m + 4 (reference eventstats.hm)."""
    z = z2m(phases, m=m)
    return float(np.max(z - 4.0 * np.arange(1, m + 1) + 4.0))


def hmw(phases, weights, m=20):
    """Weighted H-test (Kerr 2011; reference eventstats.hmw)."""
    z = z2m(phases, m=m, weights=weights)
    return float(np.max(z - 4.0 * np.arange(1, m + 1) + 4.0))


def sf_z2m(z2, m=2):
    """Survival function of Z^2_m: chi^2 with 2m dof."""
    from scipy.stats import chi2

    return float(chi2.sf(z2, 2 * m))


def sf_hm(h, m=20):
    """H-test survival function, exp(-0.398405 H) (de Jager &
    Buesching 2010; reference eventstats.sf_hm).  The calibration was
    derived for the standard m=20 harmonic search; other m warn and
    use the same formula as an approximation."""
    if m != 20:
        import warnings

        warnings.warn(
            "sf_hm's exp(-0.398405 H) null calibration is for the "
            f"m=20 H-test; m={m} significance is approximate")
    return float(np.exp(-0.398405 * h))


def sig2sigma(sf):
    """Survival probability -> equivalent Gaussian sigma."""
    from scipy.stats import norm

    return float(norm.isf(sf))


def sigma2sig(sigma):
    from scipy.stats import norm

    return float(norm.sf(sigma))
