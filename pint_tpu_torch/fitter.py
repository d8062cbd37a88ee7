"""GLS Gauss-Newton fitter (pint_tpu fitter.py: ``resid_and_design``,
``GLSFitter`` at its baseline rung).

Each iteration builds the hybrid design matrix — closed-form columns
for the phase-linear parameters, ``torch.func.jacfwd`` over the
nonlinear rest (it composes through the ``autograd.Function``s around
kernel K1 and the Kepler solve) — and solves the noise-augmented normal
equations.  With no free noise parameter, sigma, phi and the (K, K)
noise gram are constants of the fit, built once; the delays of frozen
components are computed once too.

Not ported: the guard's degradation ladder.  A non-finite chi^2 raises
:class:`FitDivergedError`, and ``model.values`` is never written with
non-finite results.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch.linalg import gls_normal_solve, noise_gram_precompute
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


class GLSFitter:
    """Generalized least squares over the low-rank noise basis.

    ``GLSFitter(toas, model, tzr, device=None).fit_toas(maxiter=3)``
    runs on CUDA unless ``device`` names another device."""

    def __init__(self, toas, model, tzr=None, device=None):
        self.device = resolve_device(device)
        self.toas = toas
        self.model = model
        self.resids = Residuals(toas, model, tzr=tzr, device=self.device)
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
        """sigma, phi and the (K, K) noise gram at the current values."""
        with torch.no_grad():
            base = self.prepared.values_dict()
            sigma = self.resids.sigma_at(base)
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

    def _step(self, vec, base_values, data):
        """(new vec, chi2 at vec, dpar, cov, noise coeffs, SolveDiag)."""
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
        dpar, cov, ncoef, chi2, diag = gls_normal_solve(
            r, J, sigma, U, phi, gram=gram, with_health=True)
        return vec + dpar, chi2, dpar, cov, ncoef, diag

    def _iterate(self, maxiter):
        vec = torch.tensor([self.model.values[k] for k in self._traced_free],
                           dtype=torch.float64, device=self.device)
        base = self.prepared.values_dict()
        chi2_prev = None
        cov = None
        diag = None
        self.chi2_iters = []
        for _ in range(maxiter):
            vec_new, chi2, _dpar, cov, _ncoef, diag = self._step(
                vec, base, self._fit_data)
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
