"""Bayesian timing: priors, likelihood, posterior and prior transform
over the free parameters (pint_tpu bayesian.py).

:class:`BayesianTiming` exposes ``lnprior``, ``prior_transform``,
``lnlikelihood`` and ``lnposterior`` as pure functions of the
free-parameter vector, so ``torch.func.vmap`` batches them over walkers
(:mod:`pint_tpu_torch.sampler`) and ``torch.func.jacfwd`` differentiates
the white branch.  The likelihood is the WLS or GLS one by the model's
noise content.

When no free parameter belongs to the noise model, sigma, the basis U
and phi do not change between walkers: the Woodbury capacity factor is
built once (:func:`~pint_tpu_torch.linalg.woodbury_precompute`) and each
batch of walkers costs one launch of kernel K8, as a chi^2 grid does.
That is the same function as the per-walker capacity Cholesky of the
reference (``Residuals.lnlikelihood_at``, which sampled noise
parameters take).  K8 has no derivative rule, so a gradient of the
correlated posterior raises naming it; the white one differentiates.

Priors are uniform or normal per parameter.  A parameter with an
uncertainty gets Uniform(value +- width_sigma * uncertainty) unless one
is given; one without raises.  Not ported: ``wideband=True`` (ROADMAP
queue 1 item 10).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from pint_tpu_torch.linalg import woodbury_chi2_logdet_pre, woodbury_precompute
from pint_tpu_torch.residuals import Residuals

__all__ = ["UniformPrior", "NormalPrior", "BayesianTiming"]


@dataclass
class UniformPrior:
    lo: float
    hi: float

    def lnpdf(self, x):
        inside = (x >= self.lo) & (x <= self.hi)
        return torch.where(inside, torch.full_like(
            x, -math.log(self.hi - self.lo)), -math.inf)

    def transform(self, u):
        return self.lo + u * (self.hi - self.lo)


@dataclass
class NormalPrior:
    mu: float
    sigma: float

    def lnpdf(self, x):
        z = (x - self.mu) / self.sigma
        return -0.5 * z * z - math.log(self.sigma) \
            - 0.5 * math.log(2.0 * math.pi)

    def transform(self, u):
        return self.mu + self.sigma * torch.special.ndtri(u)


class BayesianTiming:
    """lnprior / lnlikelihood / lnposterior / prior_transform over the
    free parameters of ``model`` given ``toas`` (pint_tpu
    bayesian.py:59), on ``device`` (CUDA unless given).

    priors: optional {name: UniformPrior | NormalPrior}; a parameter not
    listed gets Uniform(value +- width_sigma * uncertainty), the
    uncertainty from ``model.uncertainties`` (a fit's, or the par's)."""

    def __init__(self, model, toas, priors=None, width_sigma=10.0,
                 wideband=False, tzr=None, device=None):
        if wideband:
            raise NotImplementedError(
                "BayesianTiming(wideband=True): wideband residuals are not "
                "ported (ROADMAP queue 1 item 10)")
        self.resids = Residuals(toas, model, tzr=tzr, device=device)
        self.prepared = self.resids.prepared
        self.device = self.resids.device
        self.model = model
        self.toas = toas
        self.param_names = list(model.free_params)
        self.nparams = len(self.param_names)
        priors = priors or {}
        self.priors = {}
        for name in self.param_names:
            if name in priors:
                self.priors[name] = priors[name]
                continue
            pprior = getattr(model.params.get(name), "prior", None)
            if pprior is not None:
                self.priors[name] = pprior
                continue
            unc = model.uncertainties.get(name)
            if not unc:
                raise ValueError(
                    f"parameter {name} has no uncertainty to build a "
                    "default prior from; pass an explicit prior")
            val = float(model.values[name])
            w = width_sigma * float(unc)
            self.priors[name] = UniformPrior(val - w, val + w)
        self._base = self.prepared.values_dict()
        noise_owned = {p for c in model.noise_components for p in c.params}
        self._pre = self._white = None
        if noise_owned.isdisjoint(self.param_names):
            with torch.no_grad():
                sigma = self.resids.sigma_at(self._base)
                if model.has_correlated_errors:
                    U, phi = self.resids._noise_basis_phi_at(self._base)
                    self._pre = woodbury_precompute(sigma, U, phi)
                else:
                    self._white = (sigma, 2.0 * torch.sum(torch.log(sigma)))

    # -- pure functions of the free-parameter vector -------------------------
    def _values_of(self, vec):
        values = dict(self._base)
        for i, name in enumerate(self.param_names):
            values[name] = vec[i]
        return values

    def lnprior(self, vec):
        lnp = 0.0
        for i, name in enumerate(self.param_names):
            lnp = lnp + self.priors[name].lnpdf(vec[i])
        return lnp

    def prior_transform(self, cube):
        """Unit hypercube -> parameter vector (for nested samplers)."""
        return torch.stack([self.priors[name].transform(cube[i])
                            for i, name in enumerate(self.param_names)])

    def lnlikelihood(self, vec):
        values = self._values_of(vec)
        if self._pre is None and self._white is None:
            return self.resids.lnlikelihood_at(values)
        r = self.resids.time_resids_at(values)
        n = r.shape[-1]
        if self._pre is not None:
            chi2, logdet = woodbury_chi2_logdet_pre(r, self._pre)
        else:
            sigma, logdet = self._white
            chi2 = torch.sum((r / sigma) ** 2)
        return -0.5 * (chi2 + logdet) - 0.5 * n * math.log(2.0 * math.pi)

    def lnposterior(self, vec):
        # the likelihood is evaluated whatever the prior (no branch): a
        # -inf prior dominates the sum
        return self.lnprior(vec) + self.lnlikelihood(vec)

    # -- convenience ---------------------------------------------------------
    def start_vector(self):
        return np.array([self.model.values[n] for n in self.param_names],
                        dtype=np.float64)

    def scale_vector(self):
        """Per-parameter scale for walker initialization (uncertainty, or
        prior width / 100 when only a prior exists)."""
        out = []
        for name in self.param_names:
            unc = self.model.uncertainties.get(name)
            if unc:
                out.append(float(unc))
            else:
                p = self.priors[name]
                out.append((p.hi - p.lo) / 100.0
                           if isinstance(p, UniformPrior) else p.sigma)
        return np.array(out)

    def sample(self, nwalkers=32, nsteps=500, seed=0, burn_frac=0.25):
        """Run the ensemble sampler on lnposterior on this posterior's
        device; returns (flatchain, sampler) and sets the model's values
        to the max-posterior sample."""
        from pint_tpu_torch.sampler import EnsembleSampler

        s = EnsembleSampler(self.lnposterior, nwalkers=nwalkers, seed=seed,
                            device=self.device)
        x0 = s.initial_ball(self.start_vector(), self.scale_vector())
        s.run_mcmc(x0, nsteps)
        best, _ = s.max_posterior()
        for i, name in enumerate(self.param_names):
            self.model.values[name] = float(best[i])
        return s.flatchain(burn=int(burn_frac * nsteps)), s
