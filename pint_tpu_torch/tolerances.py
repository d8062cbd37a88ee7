"""Tolerances that hold the port's fit to the pint_tpu answer.

The GLS step and covariance come from an eigendecomposition of the
column-normalized normal matrix.  Any two correct eigensolvers (JAX's
CPU LAPACK, PyTorch's CPU LAPACK, cuSOLVER) agree on it only to about
eps * kappa relative in its weakest directions, kappa being the
matrix's condition number: on the B1855-like DD model the near-circular
orbit (ECC ~ 2e-5) makes T0 and OM nearly degenerate, kappa ~ 1e11 at
10k TOAs and ~ 1e13 at 400.  The reference answer itself moves by that
much under a one-ulp perturbation of its design matrix
(``tools/torch_fit_sensitivity.py``), so no port can be held closer.

Each fit criterion is therefore the nominal pin or the conditioning
bound ``2 * eps * kappa``, whichever is larger.
"""

from __future__ import annotations

import numpy as np

#: nominal pins: fitted values in units of their uncertainty, chi^2 of
#: each iteration and uncertainties relative
VALUES_SIGMA = 1e-6
CHI2_REL = 1e-8
UNC_REL = 1e-8
#: prefit time residuals [s]
PREFIT_S = 1e-11

_EPS = float(np.finfo(np.float64).eps)


def conditioning_bound(cond_log10: float) -> float:
    """2 * eps * kappa for kappa = 10**cond_log10."""
    return 2.0 * _EPS * 10.0 ** float(cond_log10)


def fit_tolerances(cond_log10: float) -> dict:
    """{'values_sigma', 'chi2_rel', 'unc_rel'} for a fit whose last
    normal-matrix solve had condition number 10**cond_log10."""
    s = conditioning_bound(cond_log10)
    return {"values_sigma": max(VALUES_SIGMA, s),
            "chi2_rel": max(CHI2_REL, s),
            "unc_rel": max(UNC_REL, s)}


def fit_errors(values, uncs, chi2_iters, ref_values, ref_uncs,
               ref_chi2_iters) -> dict:
    """Observed worst-case disagreements, in the units of
    :func:`fit_tolerances`."""
    values, uncs = np.asarray(values), np.asarray(uncs)
    ref_values, ref_uncs = np.asarray(ref_values), np.asarray(ref_uncs)
    c, rc = np.asarray(chi2_iters), np.asarray(ref_chi2_iters)
    n = min(len(c), len(rc))
    return {
        "values_sigma": float(np.max(np.abs(values - ref_values)
                                     / ref_uncs)),
        "chi2_rel": float(np.max(np.abs(c[:n] / rc[:n] - 1.0)))
        if len(c) == len(rc) else float("inf"),
        "unc_rel": float(np.max(np.abs(uncs / ref_uncs - 1.0))),
    }
