"""Downhill fitters: Gauss-Newton with step halving (pint_tpu
downhill.py, the reference's default fitters).

Each iteration proposes the WLS or GLS step ``dpar`` at the current
parameters, then tries lambda = 1, 1/2, 1/4, ... (at most
``max_halvings`` halvings) until ``chi2(vec + lambda dpar)`` is below
the chi^2 at ``vec``; a NaN chi^2 (an invalid model, SINI pushed past 1)
counts as worse and keeps halving.  If even the smallest lambda fails,
the fitter stays put.  The fit stops when an iteration lowers chi^2 by
less than ``min_chi2_decrease`` (``converged``).

Where the reference runs the halving as a ``lax.while_loop`` inside one
device program, here it is a host loop: each try is one chi^2 evaluation
on the device (kernel K1 in the phase fold, K2 in the GLS segment sums)
and one device-to-host read of its value.  Not ported: ``fit_noise``
(the noise-parameter stage needs ``lnlikelihood_at``) and the wideband
downhill fitter.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.fitter import FitDivergedError, GLSFitter, WLSFitter

__all__ = ["DownhillWLSFitter", "DownhillGLSFitter"]


class _DownhillMixin:
    """The lambda-halving loop around a fitter's Gauss-Newton step."""

    #: 16 halvings reach lambda ~ 1.5e-5 (pint_tpu downhill.py:43)
    max_halvings = 16
    #: stop when an iteration lowers chi^2 by less than this
    min_chi2_decrease = 1e-2

    def _chi2_at(self, base_values, vec) -> float:
        return float(self.resids.chi2_at(self._merged(base_values, vec)))

    def _halving_step(self, vec, base_values, data):
        """Propose dpar at vec, then take the largest lambda in {1, 1/2,
        ...} whose step lowers chi^2.  Returns (new vec, chi2 at vec,
        accepted chi2, cov, SolveDiag)."""
        dpar, chi2_old, cov, diag = self._propose(vec, base_values, data)
        lam = 1.0
        chi2_new = self._chi2_at(base_values, vec + dpar)
        n = 0
        # not (new < old): a NaN chi^2 counts as worse
        while not chi2_new < chi2_old and n < self.max_halvings:
            lam *= 0.5
            chi2_new = self._chi2_at(base_values, vec + lam * dpar)
            n += 1
        if not chi2_new < chi2_old:
            lam, chi2_new = 0.0, chi2_old
        self.step_lambdas.append(lam)
        return vec + lam * dpar, chi2_old, chi2_new, cov, diag

    def _iterate(self, maxiter):
        vec = torch.tensor([self.model.values[k] for k in self._traced_free],
                           dtype=torch.float64, device=self.device)
        base = self.prepared.values_dict()
        cov = diag = None
        self.chi2_iters = []
        #: the lambda each iteration took (0 when it stayed put)
        self.step_lambdas = []
        self.converged = False
        for _ in range(maxiter):
            vec, chi2_old, chi2_new, cov, diag = self._halving_step(
                vec, base, self._fit_data)
            if not chi2_old == chi2_old or abs(chi2_old) == float("inf"):
                raise FitDivergedError(
                    f"non-finite chi2 at iteration {len(self.chi2_iters)}")
            self.chi2_iters.append(chi2_new)
            if chi2_old - chi2_new < self.min_chi2_decrease:
                self.converged = True
                break
        return vec, cov, diag

    def fit_toas(self, maxiter=20, fit_noise=False) -> float:
        """Iterate downhill steps (at most ``maxiter``); write back values
        and uncertainties; return the chi^2 at the fitted values."""
        if fit_noise:
            raise NotImplementedError(
                "fit_noise: the noise-parameter stage is not ported "
                "(ROADMAP queue 1 item 11: it waits for a reverse-mode "
                "rule of kernel K2, segment_sum, and the noise stage)")
        return super().fit_toas(maxiter=maxiter)


class DownhillWLSFitter(_DownhillMixin, WLSFitter):
    """Step-halving WLS (pint_tpu downhill.py:291)."""

    def _propose(self, vec, base_values, data):
        dpar, _chi2w, cov, diag = WLSFitter._step(self, vec, base_values,
                                                  data)
        return dpar, self._chi2_at(base_values, vec), cov, diag


class DownhillGLSFitter(_DownhillMixin, GLSFitter):
    """Step-halving GLS (pint_tpu downhill.py:302)."""

    def _propose(self, vec, base_values, data):
        dpar, chi2, cov, diag = GLSFitter._step(self, vec, base_values,
                                                data)
        return dpar, float(chi2), cov, diag
