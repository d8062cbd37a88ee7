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
import torch

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
#: the dense log-likelihood under a singular ORF (monopole rank 1,
#: dipole rank 3), relative: kron(orf, diag(phi_gw)) has an exact null
#: space that only the 1e-12 relative ridge keeps positive, so each GW
#: block's kappa is ~1e12 and the dense factorization's own noise, ~eps
#: kappa, reaches 1e-5 of the affected terms.  The reference's own pin
#: for these ORFs (tests/test_kron_hmc.py:279-290).
GW_SINGULAR_REL = 2e-5


def crn_capacity_limit(p: int, kappa: float) -> float:
    """K11 against its plain version: |S_kernel - S_plain| within this
    times max |S_plain| per point, and logdet phi within this times (its
    count of log terms + |logdet phi|).  Each inverts P x P blocks of
    condition number ``kappa`` by another route (K11 by blocks in shared
    memory, the plain version the whole dense prior by LAPACK /
    cuSOLVER); a Cholesky inverse is accurate to ~P eps kappa of its
    largest entry, each log L_aa to ~P eps kappa, and the K terms of the
    logdet, summed in other orders, to ~eps of their magnitude.

    The dense posterior's gradient in phi_gw is a dot product with those
    inverses (``linalg.crn_capacity_bwd_plain``), so under a singular
    ORF (kappa ~1e12) it is good only to this relative to max |g|: the
    ridge that keeps such a block positive, 1e-12 of its diagonal, is
    stored to eps / 1e-12 ~ 1e-4 of itself, and the inverse's large
    entries (~kappa / phi_gw) with it, on every route.  Measured on
    tests/test_torch_hmc_dense.py's ``small`` array (kappa 4e12 under
    the monopole, 2.5e12 under the dipole) as a share of max |g|: the
    reference's own dense gradient from the port's kron one 5.7e-4 and
    1.6e-4, the port's dense gradient from the kron one 6.9e-4 and
    8.8e-5 and from the reference's dense one 2.6e-4 and 6.9e-5, K11b's
    plain version from autograd through the dense prior's Cholesky
    4.2e-4 (monopole); the limit here is 3.5e-3 and 2.2e-3.
    ``GW_SINGULAR_REL`` holds the values there, not the gradient."""
    return p * _EPS * kappa


def crn_capacity_bwd_limit(p: int) -> float:
    """K11b against its plain version on the same inputs (the same
    blocks' inverses M): per output entry, this times the entry's sum of
    the absolute values of its terms (the plain formula on -|gS|, |gld|
    and |M|).  A GW entry is a sum of P^2 products gM_ab (M_ab + M_ba) /
    2 (two roundings each) and gld P, summed in another order than the
    plain version's, then a subtraction and a division: a recursive sum
    of n terms is exact to (n - 1) eps of the sum of their magnitudes,
    so (P^2 + 4) eps bounds each route.  A noise entry is the same
    elementwise operations in both."""
    return (p * p + 4) * _EPS


def crn_block_kappa(orf, phi_gw) -> float:
    """The largest 2-norm condition number of the dense prior's GW
    blocks phi_gw[k] orf + 1e-12 diag(|phi_gw[k] orf_aa| + 1e-30) over
    every k of ``phi_gw`` (..., m2) (numpy)."""
    orf = np.asarray(orf, np.float64)
    d = np.abs(np.diag(orf))
    return max(float(np.linalg.cond(
        pg * orf + np.diag(1e-12 * (np.abs(pg * d) + 1e-30))))
        for pg in np.asarray(phi_gw, np.float64).ravel())


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
    element.  A torch ``ref`` is compared on its own device (the wide
    forms' L and X run to gigabytes on the card)."""
    if isinstance(ref, torch.Tensor):
        ref = ref.to(torch.float64)
        got = torch.as_tensor(got, dtype=torch.float64, device=ref.device)
        scale = float(torch.max(torch.abs(ref)))
        return float(torch.max(torch.abs(got - ref))) / scale if scale \
            else float(torch.max(torch.abs(got)))
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = float(np.max(np.abs(ref)))
    return float(np.max(np.abs(got - ref))) / scale if scale else \
        float(np.max(np.abs(got)))


# --------------------------------------------------------------------------
# the timing posterior and its ensemble sampler (the 10k par/tim chains of
# pint_tpu_torch/data/b1855_mcmc_answers.npz, 32 walkers x 200 steps, and
# the 400-TOA chains of the tests)
# --------------------------------------------------------------------------

#: lnposterior against JAX's, in absolute units: the limit on an lnp of
#: size |lnp| is MCMC_LNP_ABS + MCMC_LNP_REL |lnp|.  The reference's own
#: movement, stored in the answers file: its two forms of the GLS
#: posterior (a capacity Cholesky per walker; one Woodbury factor) differ
#: by up to 2.9e-6, and the same posterior in two compiled programs (the
#: chain's scan, a jit of the vmap) by up to 7.1e-13 |lnp| (WLS, |lnp|
#: ~ 5e9).  The port's lnp carries besides the difference of its
#: residuals from JAX's, 7.8e-14 s on the 10k par/tim (the ingest's
#: agreement, held to PREFIT_S): chi^2 moves by 2 sum r dr / sigma^2,
#: which grows with the residuals, so the limit has a part proportional
#: to |lnp| (chi^2 ~ 2 |lnp| away from the peak).  Over both 10k chains
#: on the CPU (12 800 lnps) the port differs from JAX by at most 3.5e-5
#: where |lnp| < 2e5 (the peak is at 1.2e5, where the logdet of C in s^2
#: dominates), 9.2e-5 below 1e6 and 4.2e-11 |lnp| beyond.  On the card
#: the fold's transcendentals round by CUDA's library (an ulp of the
#: ~500 s Roemer delay is 1.1e-13 s, the size of dr above), which may
#: double that.  One flat absolute part serves every |lnp| below 1e6:
#: three times the 9.2e-5 maximum of that range, which is about nine
#: times the maximum at the peak; the relative part is 2.4 times the
#: maximum beyond.
MCMC_LNP_ABS = 3e-4
MCMC_LNP_REL = 1e-10
#: accept decisions and positions against JAX's: a decision whose
#: margin |lnratio - log u| is below the sum of the lnp limits of the
#: two lnps it compares (lnp_prop and the walker's lnp) is a near tie,
#: which may go either way between two implementations within the
#: limit.  A chain is held to JAX's up to the first near tie that went
#: the other way (:func:`chain_parting_step`), which ends the comparison
#: (the two chains part there); any other decision that differs fails.
#: Up to it every decision is the same and positions are bit-identical
#: (0 ulp): the proposal's arithmetic repeats XLA's (fused
#: multiply-adds, the division by a as a product with 1/a).  Over the
#: two 10k chains on the CPU one decision is a near tie (GLS, step 146,
#: margin 3.7e-4 at the peak against a limit of 6.2e-4; it went JAX's
#: way there, so both chains are held for all 200 steps) and the
#: smallest WLS margin is 3.5e-3.
MCMC_POSITION_ULPS = 0


def mcmc_lnp_limit(lnp_ref):
    """The lnp limit of :data:`MCMC_LNP_ABS` and :data:`MCMC_LNP_REL`
    at reference values ``lnp_ref`` (NaN where the reference is NaN)."""
    return MCMC_LNP_ABS + MCMC_LNP_REL * np.abs(np.asarray(lnp_ref,
                                                           np.float64))


def mcmc_lnp_ok(got, ref) -> bool:
    """Every lnp within its limit; NaN only where the reference is NaN
    and -inf only where it is -inf."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    same = np.isnan(got) == np.isnan(ref)
    inf = np.isinf(got) | np.isinf(ref)
    fin = ~np.isnan(ref) & ~inf
    return bool(np.all(same) and np.all(got[inf] == ref[inf])
                and np.all(np.abs(got[fin] - ref[fin])
                           <= mcmc_lnp_limit(ref[fin])))


def near_ties(margin, lnp_prop, lnp_before):
    """Mask of the near-tie decisions: |margin| below the sum of the lnp
    limits of the two lnps the decision compares."""
    return np.abs(margin) < (mcmc_lnp_limit(lnp_prop)
                             + mcmc_lnp_limit(lnp_before))


def chain_parting_step(margin, lnp_prop, lnp_before, accepted,
                       accepted_ref) -> int:
    """The first step at which a near tie (:func:`near_ties`) was decided
    otherwise than in the reference, or the number of steps if none
    was: the chains are comparable before it.  ``margin``, ``lnp_prop``
    and ``lnp_before`` are (nsteps, 2, nwalkers / 2) as
    ``sampler.decision_margins`` gives them; ``accepted`` and
    ``accepted_ref`` are (nsteps, nwalkers), first half then second."""
    margin = np.asarray(margin)
    nsteps = margin.shape[0]
    differ = (np.asarray(accepted, bool) != np.asarray(accepted_ref, bool)) \
        .reshape(margin.shape)
    parted = (differ & near_ties(margin, lnp_prop, lnp_before)) \
        .any(axis=(1, 2))
    return int(np.argmax(parted)) if parted.any() else nsteps


# --------------------------------------------------------------------------
# streaming appends (the 10k par/tim stream of
# pint_tpu_torch/data/b1855_stream_answers.npz, and the tests' streams)
# --------------------------------------------------------------------------

#: JAX's own movement of a streamed night's chi^2, relative, measured by
#: ``tools/export_torch_stream_case.py`` on the 10k par/tim stream (11
#: nights of 25 TOAs, GLS and WLS; stored per night in
#: b1855_stream_answers.npz as ``*_chi2_moments_ulp_rel`` and
#: ``*_chi2_start_ulp_rel``): the whole stream run again with every
#: captured moment moved by one ulp moves the chi^2 of a night by up to
#: 4.7e-9 (it grows from 2e-16 at night 0 as the steps carry it), and
#: with every fitted value it starts from moved by one ulp by up to
#: 7.3e-9 from night 1 on.  (At night 0 the start moves it by 2.1e-6 GLS
#: and 1.5e-4 WLS: one ulp of F0 is half its sigma there, a move the
#: port's start, held to the fit limits, does not make.)  The reported
#: chi^2 is at the pre-step vector, so it is first order in the iterate,
#: and the moments' cancellation (rr - y_u^T cap^-1 y_u) rides on it.
STREAM_CHI2_MOMENTS_MOVE = 4.686478760618229e-09
STREAM_CHI2_START_MOVE = 7.287487280294158e-09
#: a triage decision (|z| > 7 against the pre-append fit) is a near tie
#: when its margin | |z| - 7 | is below this: z = (q - mu) / sigma moves
#: with the residuals, which the port holds to PREFIT_S = 1e-11 s of
#: JAX's, over the smallest uncertainty of the case (1 us).  Streams are
#: compared up to the first near tie decided otherwise.
STREAM_Z_TIE = PREFIT_S / 1e-6
#: the normal-block functions against JAX's on the same inputs, as
#: :func:`vector_rel` (the same operations; matmul sums in other orders)
STREAM_BLOCKS_REL = 1e-12


def stream_chi2_limit() -> float:
    """The limit on a streamed night's chi^2 against JAX's, relative.
    The port's stream differs from JAX's in both places that move it:
    its start (the base fit) and its moments (summed in another order),
    each by about an ulp's worth where it matters, so the two measured
    movements add; each package carries its own rounding, so the sum
    doubles: 2 (4.7e-9 + 7.3e-9) = 2.4e-8 (the CPU shows up to 6.7e-9)."""
    return 2.0 * (STREAM_CHI2_MOMENTS_MOVE + STREAM_CHI2_START_MOVE)


def stream_fit_tolerances(cond_log10, centering) -> dict:
    """:func:`fit_tolerances` of a streamed refit.  The refit centers
    raw moments, a_jj = a_qq - s_j s_j^T / s_w: each centered entry
    carries the rounding of the raw ones, eps |a_qq|, so relative to
    the normalized matrix its error is eps times ``centering`` =
    max_i a_qq[i, i] / a_jj[i, i] (2.87 on the 10k GLS stream) and the
    conditioning bound grows by that factor.  On the card the GLS
    stream's uncertainties differ from JAX's by up to 1.3 times
    2 eps kappa at night 5 (0.46 of this limit)."""
    return fit_tolerances(float(cond_log10)
                          + float(np.log10(max(float(centering), 1.0))))


def stream_moments_limit(n_rows, abs_sum):
    """Kernel K10 (and its plain version) against any other float64
    order of the same sum: per entry, n eps times the sum of the
    absolute values of its terms (and of the S it adds to), the
    worst-case bound of a recursive sum of n terms."""
    return (n_rows + 1) * _EPS * np.asarray(abs_sum)


# --------------------------------------------------------------------------
# the PTA batch (pint_tpu_torch/data/pta68_500_batch.npz, 68 pulsars x 500
# TOAs at gbt, and the tests' 4-pulsar array)
# --------------------------------------------------------------------------

#: the batch's residuals against JAX's [s], for its chi^2 at fixed
#: values: on the CPU the port's residuals of the 68 x 500 batch differ
#: from JAX's by up to 2.477e-13 s (every member 2.1-2.5e-13: an ulp or
#: two of each TOA's ~500 s Roemer delay through gbt's geometry; the
#: tests' 4-pulsar array 7.0e-14 s).  On the card the fold's
#: transcendentals round by CUDA's library, which may double that, as
#: MCMC_LNP_ABS allows; so twice the CPU's maximum.
PTA_RESID_DIFF_S = 2 * 2.477e-13


def pta_chi2_limit(cinv_r, sigma, valid=None):
    """The limit on each member's chi^2 = r^T C^-1 r against JAX's that
    the residuals' disagreement alone allows, absolute: residuals that
    move by at most dr = :data:`PTA_RESID_DIFF_S` move it by 2 dr^T C^-1
    r + dr^T C^-1 dr, at most 2 dr |C^-1 r|_1 + dr^2 sum 1 / sigma^2
    (C^-1 <= N^-1).  ``cinv_r`` is C^-1 r: r / sigma^2 for the white
    chi^2 of ``PTABatch.chisq`` and of a WLS fit, the Woodbury solve for
    a GLS fit's.  ``cinv_r`` and ``sigma`` (k, n); ``valid`` masks pad
    rows out.  On the CPU the 68 x 500 batch's white chi^2 differs from
    JAX's by up to 3.4e-6 at chi^2 ~ 300 (9.6e-9 relative), 2.9 % of
    this limit (5.8 % of the bound at the measured dr).  A fit's chi^2
    is held to this plus the conditioning part of
    :func:`fit_tolerances`: on few TOAs this part is the larger (the
    tests' 40-TOA GLS member: 1.1e-8 relative, over the nominal 1e-8;
    ROADMAP watch list, ulp-level residuals)."""
    w = 1.0 / np.asarray(sigma, np.float64) ** 2
    a = np.abs(np.asarray(cinv_r, np.float64))
    if valid is not None:
        valid = np.asarray(valid, bool)
        w, a = np.where(valid, w, 0.0), np.where(valid, a, 0.0)
    dr = PTA_RESID_DIFF_S
    return 2.0 * dr * np.sum(a, axis=-1) + dr * dr * np.sum(w, axis=-1)
