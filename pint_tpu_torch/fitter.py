"""Gauss-Newton fitters (pint_tpu fitter.py: ``resid_and_design``,
``wls_gn_solve``, the ``Fitter`` base, ``WLSFitter`` and ``GLSFitter``
at their baseline rung).

Each iteration builds the hybrid design matrix — closed-form columns
for the phase-linear parameters, ``torch.func.jacfwd`` over the
nonlinear rest (it composes through the ``autograd.Function``s around
kernel K1 and the Kepler solve) — and solves for the step:
:class:`GLSFitter` through the noise-augmented normal equations,
:class:`WLSFitter` through the SVD of the whitened, column-normalized
design (whitening by kernel K7 on CUDA).  With no free noise parameter,
sigma (and for GLS phi and the (K, K) noise gram) are constants of the
fit, built once; the delays of frozen components are computed once too.

The fitters take a :class:`~pint_tpu_torch.toa.TOATable` with its TZR
table, or ingest :class:`~pint_tpu_torch.toa.TOAs` (the TZR TOA then
comes from the model).  Not ported: the guard's degradation ladder.  A
non-finite chi^2 raises :class:`FitDivergedError`, and ``model.values``
is never written with non-finite results.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch.linalg import (SolveDiag, gls_normal_solve,
                                   noise_gram_precompute, wls_whiten)
from pint_tpu_torch.residuals import Residuals


class FitDivergedError(RuntimeError):
    """A Gauss-Newton step produced a non-finite chi^2."""


def resid_and_design(free, vec, partition, resid_of, linear_of):
    """(r, J) at the free-parameter vector ``vec``: the analytic columns
    for the linear names, ``jacfwd`` over the nonlinear remainder,
    gathered back into free order."""
    lin, nl = partition
    free = tuple(free)
    full = {name: vec[i] for i, name in enumerate(free)}
    r = resid_of(full)
    if not lin:
        def resid_fn(v):
            return resid_of({name: v[i] for i, name in enumerate(free)})

        return r, torch.func.jacfwd(resid_fn)(vec)
    idx = {name: i for i, name in enumerate(free)}
    J_lin = linear_of(full)
    if nl:
        nl_idx = torch.as_tensor([idx[p] for p in nl], device=vec.device)

        def resid_nl(nv):
            sub = dict(full)
            for j, p in enumerate(nl):
                sub[p] = nv[j]
            return resid_of(sub)

        J_nl = torch.func.jacfwd(resid_nl)(vec[nl_idx])
        blocks = torch.cat([J_nl, J_lin], dim=1)
    else:
        blocks = J_lin
    order = {p: j for j, p in enumerate(tuple(nl) + tuple(lin))}
    perm = [order[p] for p in free]
    if perm == list(range(len(free))):
        return r, blocks
    return r, blocks[:, torch.as_tensor(perm, device=vec.device)] \
        .contiguous()


#: singular values at or below this times the largest are dropped from the
#: WLS step (pint_tpu fitter.py:124's default)
WLS_SVD_THRESHOLD = 1e-14


def wls_gn_solve(r, J, err):
    """One whitened, column-normalized SVD Gauss-Newton step (pint_tpu
    fitter.py:124, guard off).  Returns (dpar, chi2 at the input, cov,
    SolveDiag): singular values at or below ``WLS_SVD_THRESHOLD`` times
    the largest are dropped, and the diagnostics count them
    (``n_truncated``) and give log10 of the largest over the smallest
    kept (``cond_log10``).  The whitening pass is kernel K7 on CUDA;
    the SVD is ``torch.linalg.svd``."""
    rw, Jn, norms, chi2 = wls_whiten(r, J, err)
    U, s, Vt = torch.linalg.svd(Jn, full_matrices=False)
    smax = torch.max(s)
    keep = s > WLS_SVD_THRESHOLD * smax
    s_inv = torch.where(keep, 1.0 / s, torch.zeros_like(s))
    dpar = -((Vt.T * s_inv[None, :]) @ (U.T @ rw)) / norms
    cov = ((Vt.T * s_inv[None, :] ** 2) @ Vt) / torch.outer(norms, norms)
    kept_min = torch.min(torch.where(keep, s, smax))
    diag = SolveDiag(
        n_truncated=torch.sum(~keep).to(torch.int32),
        cond_log10=torch.log10(smax / torch.clamp(kept_min, min=1e-300)))
    return dpar, chi2, cov, diag


class Fitter:
    """The Gauss-Newton loop shared by the fitters: ``Fitter(toas,
    model, tzr=None, device=None).fit_toas(maxiter=3)`` runs on CUDA
    unless ``device`` names another device.  Subclasses define
    ``_step``."""

    #: whether the step reads the frozen-noise (phi, gram) leaves; every
    #: step reads sigma
    _noise_gram_leaves = False

    def __init__(self, toas, model, tzr=None, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.resids = Residuals(toas, model, tzr=tzr, device=self.device)
        self.toas = self.resids.toas
        self.prepared = self.resids.prepared
        self.covariance: Optional[np.ndarray] = None
        self.chi2_iters: list = []
        self.fit_health = None
        self._retrace()

    # -- setup ----------------------------------------------------------------
    def _retrace(self):
        """Recompute the structure of the step for the current free set:
        the frozen-delay components and their leaves, the hybrid
        partition, the frozen-noise leaves."""
        self._traced_free = tuple(self.model.free_timing_params)
        self._fit_data = self._partition_setup()

    def _partition_setup(self):
        free = self._traced_free
        prep = self.prepared
        self._frozen_names = prep.frozen_delay_split(free)
        self._partition = prep.design_partition(free,
                                                frozen=self._frozen_names)
        frozen, tzr_frozen = prep.frozen_delay_leaves(self._frozen_names)
        data = {}
        if frozen is not None:
            data["frozen"] = frozen
            if tzr_frozen is not None:
                data["tzr_frozen"] = tzr_frozen
        self._noise_owned = sorted(p for c in prep.model.noise_components
                                   for p in c.params)
        self._noise_frozen = set(self._noise_owned).isdisjoint(free)
        if self._noise_frozen:
            data.update(self._noise_leaves())
        self._leaves_fp = self._fingerprint()
        return data

    def _fingerprint(self):
        """The values the precomputed leaves were built from: an edit to
        a frozen delay or noise parameter between fits re-folds them."""
        vals = self.prepared.frozen_param_values(self._frozen_names)
        if self._noise_frozen:
            vals.update({k: float(self.model.values.get(k, np.nan))
                         for k in self._noise_owned})
        return vals

    def _refresh_leaves(self):
        fp = self._fingerprint()
        same = fp.keys() == self._leaves_fp.keys() and all(
            v == self._leaves_fp[k] or (v != v and self._leaves_fp[k] !=
                                        self._leaves_fp[k])
            for k, v in fp.items())
        if not same:
            self._fit_data = self._partition_setup()

    def _noise_leaves(self):
        """sigma (and for GLS phi and the (K, K) noise gram) at the
        current values."""
        with torch.no_grad():
            base = self.prepared.values_dict()
            sigma = self.resids.sigma_at(base)
            if not self._noise_gram_leaves:
                return {"noise_sigma": sigma}
            U, phi = self.resids._noise_basis_phi_at(base)
            return {"noise_sigma": sigma, "noise_phi": phi,
                    "noise_gram": noise_gram_precompute(sigma, U, phi)}

    # -- one Gauss-Newton step --------------------------------------------------
    def _merged(self, base_values, vec):
        values = dict(base_values)
        for i, name in enumerate(self._traced_free):
            values[name] = vec[i]
        return values

    def _rj(self, vec, base_values, data):
        def resid_of(sub):
            values = dict(base_values)
            values.update(sub)
            return self.resids.time_resids_at(values, data)

        def linear_of(sub):
            values = dict(base_values)
            values.update(sub)
            return self.resids.linear_design_at(values, self._partition[0],
                                                data)

        return resid_and_design(self._traced_free, vec, self._partition,
                                resid_of, linear_of)

    def _iterate(self, maxiter):
        vec = torch.tensor([self.model.values[k] for k in self._traced_free],
                           dtype=torch.float64, device=self.device)
        base = self.prepared.values_dict()
        chi2_prev = None
        cov = None
        diag = None
        self.chi2_iters = []
        for _ in range(maxiter):
            dpar, chi2, cov, diag = self._step(vec, base, self._fit_data)
            vec_new = vec + dpar
            chi2_f = float(chi2)
            if not np.isfinite(chi2_f):
                raise FitDivergedError(
                    f"non-finite chi2 at iteration {len(self.chi2_iters)}")
            self.chi2_iters.append(chi2_f)
            vec = vec_new
            if chi2_prev is not None and \
                    abs(chi2_prev - chi2_f) < 1e-8 * max(chi2_f, 1.0):
                break
            chi2_prev = chi2_f
        return vec, cov, diag

    # -- the fit ----------------------------------------------------------------
    def fit_toas(self, maxiter=3) -> float:
        """Iterate Gauss-Newton steps; write back values and
        uncertainties; return the chi^2 at the fitted values."""
        if not self.model.free_timing_params:
            raise ValueError("no free timing parameters to fit")
        if tuple(self.model.free_timing_params) != self._traced_free:
            self._retrace()
        else:
            self._refresh_leaves()
        # Kepler depth classes are monotone (4 -> 6 -> 8 -> 10): at most
        # three refits
        for _ in range(4):
            vec, cov, diag = self._iterate(maxiter)
            vec_np = vec.detach().cpu().numpy()
            cov_np = cov.detach().cpu().numpy()
            if not (np.all(np.isfinite(vec_np))
                    and np.all(np.isfinite(np.diag(cov_np)))):
                raise FitDivergedError("non-finite fitted parameters")
            errs = np.sqrt(np.clip(np.diag(cov_np), 0, None))
            for i, name in enumerate(self._traced_free):
                self.model.values[name] = float(vec_np[i])
                self.model.uncertainties[name] = float(errs[i])
            self.covariance = cov_np
            self.fit_health = {
                "n_truncated": int(diag.n_truncated),
                "cond_log10": float(diag.cond_log10)}
            if not self._kepler_depth_guard():
                break
        return self.resids.chi2

    def _kepler_depth_guard(self):
        """After write-back: deepen the static Newton depth when the
        fitted eccentricity left the prepare-time class; True when the
        fit must run again."""
        reach = self.prepared.kepler_ecc_reach()
        if reach == float("-inf"):
            return False
        if not self.prepared.ensure_kepler_depth(reach):
            return False
        self._retrace()
        return True


class WLSFitter(Fitter):
    """Weighted least squares: the SVD of the whitened, column-normalized
    design matrix (pint_tpu fitter.py:1620), whitened by the
    noise-scaled uncertainties (EFAC/EQUAD)."""

    def _step(self, vec, base_values, data):
        """(dpar, chi2 at vec, cov, SolveDiag)."""
        if self._noise_frozen:
            sigma = data["noise_sigma"]
        else:
            sigma = self.resids.sigma_at(self._merged(base_values, vec))
        r, J = self._rj(vec, base_values, data)
        return wls_gn_solve(r, J, sigma)


class GLSFitter(Fitter):
    """Generalized least squares over the low-rank noise basis."""

    _noise_gram_leaves = True

    def _step(self, vec, base_values, data):
        """(dpar, chi2 at vec, cov, SolveDiag)."""
        values = self._merged(base_values, vec)
        if self._noise_frozen:
            sigma = data["noise_sigma"]
            U, phi = self.resids._U_ext, data["noise_phi"]
            gram = data["noise_gram"]
        else:
            sigma = self.resids.sigma_at(values)
            U, phi = self.resids._noise_basis_phi_at(values)
            gram = None
        r, J = self._rj(vec, base_values, data)
        dpar, cov, _ncoef, chi2, diag = gls_normal_solve(
            r, J, sigma, U, phi, gram=gram, with_health=True)
        return dpar, chi2, cov, diag
