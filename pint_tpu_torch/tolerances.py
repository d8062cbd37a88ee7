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
#: ingest on another host: the observatory and solar-system geometry
#: (light-seconds, ls/s) as :func:`vector_rel`.  On one host the port's
#: numpy repeats the JAX package's arithmetic bit for bit; another
#: host's libm may round sin/cos/exp differently by an ulp, which the
#: Chebyshev and rotation chains carry to ~10 ulp of the largest
#: coordinate.  Ticks, frequencies, errors and flags are exact always.
INGEST_GEOMETRY_REL = 1e-14

_EPS = float(np.finfo(np.float64).eps)


#: chi^2 of an unfinished refit, relative: a grid point's after its
#: fixed 3 Gauss-Newton steps, and the chi^2 a downhill fit accepts at
#: each iteration.  Away from the minimum chi^2 is first order in the
#: iterate, and the iterate carries the step's rounding (eps * kappa in
#: the weak directions), so the nominal 1e-8 is not the scale: on the
#: 10k par/tim the reference's own chi^2 moves by 1.5e-8 (GLS grid) and
#: 1.2e-8 (WLS grid) with one more step, and by up to 6.0e-8 under a
#: one-ulp change of the downhill start (GLS from SINI = 0.99), as
#: ``tools/export_torch_grid_case.py`` prints and stores.  1e-7 is
#: Delta chi^2 ~ 8e-4 at chi^2 ~ 8e3: a chi^2 off by more than that,
#: a dropped term or a misweighted row, fails.
REFIT_CHI2_REL = 1e-7


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


def wls_normal_cond_log10(svd_cond_log10: float) -> float:
    """log10 of the normal matrix's kappa for a WLS step whose SVD
    reported ``svd_cond_log10``: the WLS fit solves the same normal
    equations J^T W J through the SVD of the whitened J, whose singular
    values are the square roots of that matrix's eigenvalues, and the
    Gauss-Newton iterate moves with them as the GLS one does."""
    return 2.0 * float(svd_cond_log10)


def values_sigma_ulp(got, ref, sigma) -> float:
    """max |got - ref| / sigma with each difference first reduced by one
    float64 ulp of the reference value (floored at 0).

    A chi^2 grid refits each point by a fixed number of Gauss-Newton
    steps, and a step smaller than half an ulp of a parameter leaves it
    where it was: two correct implementations whose steps round on
    either side of the half ulp differ by one ulp.  For PB = 1.07e6 s
    (ulp 2.3e-10 s) that is 5.7e-5 sigma at 10^4 TOAs, above the WLS
    grid's conditioning bound (1.9e-5); it is seen on one point of the
    16 x 16 (F0, F1) grid on the CPU."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    d = np.maximum(np.abs(got - ref) - np.spacing(np.abs(ref)), 0.0)
    return float(np.max(d / np.asarray(sigma, np.float64)))


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


# --------------------------------------------------------------------------
# the GW path (68-pulsar case on the card, the ragged test array on the
# CPU), against pint_tpu on the same inputs
# --------------------------------------------------------------------------

#: optimal statistic and its noise-marginalized draws, relative.  The
#: port whitens through the grams (z = b_f - g_uf^T cap^-1 b_u) where
#: the reference forms C^-1 F: the same algebra, rounded differently.
GW_OS_REL = 1e-9
#: the kron-structured log-likelihood, one point and the grid, relative
#: (the reference's own kron == dense pin, tests/test_kron_hmc.py)
GW_LNLIKE_REL = 1e-10
#: K3 / K4 against their plain versions on the card: per entry, a
#: multiple of the sum of the absolute values of the entry's terms
#: (the two sum in different orders; each order is exact to
#: ~n eps sum|terms|, and n <= 10^4 rows here)
KERNEL_SUM_REL = 1e-13


# --------------------------------------------------------------------------
# the GWB posterior and its sampler
# --------------------------------------------------------------------------

#: posterior gradient, max |got - ref| / max |ref| (the reference's kron
#: == dense gradient pin, tests/test_kron_hmc.py:341-355); lnprob
#: itself is held to GW_LNLIKE_REL
HMC_GRAD_REL = 1e-10
#: the per-pulsar stage (K5 outputs chi2_a, x_a, M_a, ld_a and K5b's
#: gradient), each against another route to the same function
#: (LAPACK / cuSOLVER's Cholesky, JAX's, autograd), as
#: :func:`vector_rel` over the output.  The capacity matrices
#: g_uu + diag(1/phi) mix columns of prior variance 1e30 (timing, offset)
#: and ~1e-14 s^2 (red noise): on the 68-pulsar case their raw condition
#: numbers reach 10^9.8, but Cholesky's error follows the diagonally
#: equilibrated matrix, whose kappa is 10^3.2 (median) to 10^4.5 (max)
#: there, so the forward errors are ~eps * kappa <= 7e-12 of each
#: output's scale.  The ceiling is the reference's 1e-10 kron pin.
KRON_PULSAR_REL = 1e-10
#: K7 against its plain version on the card: Jn, the column norms and
#: chi2 as :func:`vector_rel` (rw is bit-identical).  The two sum the
#: same non-negative squares in different orders; K7's longest chain is
#: ~ N / 256 + 8 + splits additions (~60 at N = 10^4) and torch.sum's is
#: pairwise, so both are within ~60 eps of the exact sum.
WLS_WHITEN_REL = 1e-13
#: chi^2 against a prebuilt Woodbury factor (kernel K8, its plain
#: version, the reference's woodbury_chi2_logdet_pre), as |d chi2| over
#: sum r^2 / n, the larger of the two terms chi2 = sum r^2/n - |z|^2
#: that cancel: the three sum U^T N^-1 r in different orders (segment
#: sums against the reference's dense indicator columns) and reach z by
#: a forward substitution or cho_solve, each ~K eps of that sum (K = 461
#: columns: ~1e-13); 1e-15 is what the CPU shows.
WOODBURY_PRE_REL = 1e-12
#: K6 against its plain version on the card: positions, momenta and
#: step sizes, in units in the last place (the two use the same
#: association and order; only the math library's exp / log may differ)
K6_ULPS = 4
#: an injected-draw trajectory against JAX's: positions in units of the
#: per-parameter scales, and lnprob / step sizes relative
HMC_PATH_SCALES = 1e-7
HMC_LNP_REL = 1e-9


def vector_rel(got, ref) -> float:
    """max |got - ref| / max |ref|: the relative error of a vector.

    Per-pair cross-powers (rho) are sums of signed terms, and a pair
    whose terms cancel has a value near zero with an absolute error of
    ~eps sum|terms|; element-wise relative error there measures the
    cancellation, not the port.  The vector's scale is its largest
    element."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = float(np.max(np.abs(ref)))
    return float(np.max(np.abs(got - ref))) / scale if scale else \
        float(np.max(np.abs(got)))
