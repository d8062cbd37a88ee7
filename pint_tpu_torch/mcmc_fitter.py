"""Photon-domain MCMC fitting: timing (and template) parameters against
the photon likelihood (pint_tpu mcmc_fitter.py).

The posterior is the priors plus the Kerr (2011) weighted photon
likelihood of the template at each photon's phase.  The phase is the
TZR-referenced fold of the prepared model (kernel K1 inside), ``frac``
floor-modded by 1; the likelihood is kernel K12 on the card
(:func:`pint_tpu_torch.templates.photon_lnlike`).  Both are pure torch
functions of the parameter vector, so the ensemble sampler
(:mod:`pint_tpu_torch.sampler`) batches a half of the walkers with
``torch.func.vmap``: one K1 and one K12 launch set per posterior call,
whatever the number of walkers.

Not ported: ``checkpoint=`` (the guard's checkpoint files, ROADMAP
queue 1 item 2), which raises, and the telemetry spans and FLOP
counters (item 16).
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch.bayesian import UniformPrior
from pint_tpu_torch.sampler import EnsembleSampler
from pint_tpu_torch.templates import (pack_template, photon_lnlike,
                                      photon_log_terms)

__all__ = ["MCMCFitter", "MCMCFitterAnalyticTemplate",
           "MCMCFitterBinnedTemplate", "CompositeMCMCFitter"]

_BINNED = (list, np.ndarray, torch.Tensor)


def _default_priors(model, names, priors, width_sigma):
    """{name: prior}: the given one, else the parameter's own, else
    Uniform(value +- width_sigma * uncertainty)."""
    out = {}
    priors = priors or {}
    for name in names:
        if name in priors:
            out[name] = priors[name]
            continue
        pprior = getattr(model.params.get(name), "prior", None)
        if pprior is not None:
            out[name] = pprior
            continue
        unc = model.uncertainties.get(name)
        if not unc:
            raise ValueError(
                f"no uncertainty for {name}; pass an explicit prior")
        val = float(model.values[name])
        w = width_sigma * float(unc)
        out[name] = UniformPrior(val - w, val + w)
    return out


def _scales(priors, names):
    return [(priors[n].hi - priors[n].lo) / 100.0
            if isinstance(priors[n], UniformPrior) else priors[n].sigma
            for n in names]


class MCMCFitter:
    """Sample timing parameters against the photon-template likelihood
    (pint_tpu mcmc_fitter.py:32), on ``device`` (CUDA unless given).

    template: an :class:`~pint_tpu_torch.templates.LCTemplate`
    (analytic) or a binned profile given as an array of bin heights.
    Weights default to the TOAs' ``-weight`` flags.  With
    ``fit_template`` the template's parameters are sampled too, after
    the timing parameters."""

    def __init__(self, toas, model, template, weights=None, priors=None,
                 width_sigma=10.0, fit_template=False, device=None):
        self.device = resolve_device(device)
        self.toas = toas
        self.model = model
        self.prepared = model.prepare(toas, device=self.device)
        self.template = template
        self.fit_template = bool(fit_template)
        if weights is None:
            wf = toas.get_flag_values("weight", default=None, astype=float)
            if any(w is not None for w in wf):
                weights = np.array([1.0 if w is None else w for w in wf])
        self.weights = None if weights is None else torch.as_tensor(
            np.asarray(weights, np.float64), device=self.device)
        self.param_names = list(model.free_params)
        self.nparams = len(self.param_names)
        self.priors = _default_priors(model, self.param_names, priors,
                                      width_sigma)
        self._base = self.prepared.values_dict()
        self._binned = isinstance(template, _BINNED)
        dev = self.device
        self._bins = None
        self._packed = None
        if self._binned:
            bins = torch.as_tensor(np.array(template, np.float64),
                                   device=dev)
            self._bins = bins / torch.mean(bins)  # normalize to density
            self._packed = (torch.zeros(0, dtype=torch.int32, device=dev),
                            torch.zeros((1, 0, 8), dtype=torch.float64,
                                        device=dev),
                            torch.zeros(1, dtype=torch.float64, device=dev))
            self._n_template = 0
        else:
            self._n_template = template.n_params if fit_template else 0
            if dev.type == "cuda" or template.k12_ready:
                self._packed = self._pack(torch.as_tensor(
                    template.params, device=dev))

    def _pack(self, tparams):
        types, rows, bg = pack_template(self.template, tparams)
        return types, rows[None], bg.reshape(1)

    # -- the posterior --------------------------------------------------------
    def _values_of(self, vec):
        values = dict(self._base)
        for i, name in enumerate(self.param_names):
            values[name] = vec[i]
        return values

    def _frac(self, vec):
        p = self.prepared
        _, frac = p._phase_raw_at(self._values_of(vec), p.batch, p.ctx,
                                  p.tzr_batch, p.tzr_ctx)
        return frac

    def _lnlike_at(self, frac, vec):
        """sum_i log(max(w f(phi_i) + 1 - w, 1e-300)) at phi = frac mod
        1: kernel K12 (or its plain version on the CPU)."""
        tparams = vec[self.nparams:] if self._n_template else None
        packed = self._packed
        if tparams is not None and (self.device.type == "cuda"
                                    or self.template.k12_ready):
            packed = self._pack(tparams)
        if packed is None:  # a primitive K12 does not cover, on the CPU
            return torch.sum(photon_log_terms(self.template.density(
                torch.remainder(frac, 1.0), tparams), self.weights))
        return photon_lnlike(frac[None], self.weights, *packed,
                             bins=self._bins, wrap=True)[0]

    def lnprior(self, vec):
        lnp = 0.0
        for i, name in enumerate(self.param_names):
            lnp = lnp + self.priors[name].lnpdf(vec[i])
        return lnp

    def lnposterior(self, vec):
        """Priors plus the photon likelihood at the vector ``vec``
        (timing parameters, then the template's when fitted)."""
        return self.lnprior(vec) + self._lnlike_at(self._frac(vec), vec)

    def lnlike_only(self, vec):
        """The photon likelihood without the priors (the composite
        fitter counts the priors once)."""
        return self._lnlike_at(self._frac(vec), vec)

    # -- the sampler run ------------------------------------------------------
    def _center_scales(self):
        center = np.array(
            [self.model.values[n] for n in self.param_names]
            + (list(self.template.params) if self._n_template else []))
        scales = _scales(self.priors, self.param_names) \
            + [0.01] * self._n_template
        return center, np.array(scales)

    def fit_toas(self, nwalkers=32, nsteps=500, seed=0, burn_frac=0.25,
                 autocorr=False, burnin=None, checkpoint=None):
        """Run the ensemble sampler on the device; set the model's values
        (and the template's, when fitted) to the max-posterior sample and
        the uncertainties to the post-burn-in spread.  Returns the
        max-posterior lnp.

        ``autocorr=True`` samples in chunks until the emcee criterion is
        met, ``nsteps`` the cap, with burn-in ``5 * max(tau)``;
        ``burnin`` (steps) overrides either default."""
        if checkpoint is not None:
            raise NotImplementedError(
                "MCMCFitter.fit_toas(checkpoint=): the guard's checkpoint "
                "files are not ported (ROADMAP queue 1 item 2)")
        center, scales = self._center_scales()
        s = EnsembleSampler(self.lnposterior, nwalkers=nwalkers, seed=seed,
                            device=self.device)
        x0 = s.initial_ball(center, scales)
        with torch.no_grad():
            if autocorr:
                _, self.converged, self.tau = s.run_mcmc_autocorr(
                    x0, chunk=max(50, nsteps // 10), maxsteps=nsteps)
                chain_len = int(np.asarray(s.chain).shape[0])
                burn = (int(burnin) if burnin is not None
                        else int(min(5 * np.max(self.tau), chain_len // 2))
                        if np.all(np.isfinite(self.tau))
                        else chain_len // 4)
            else:
                s.run_mcmc(x0, nsteps)
                chain_len = int(nsteps)
                burn = (int(burnin) if burnin is not None
                        else int(burn_frac * nsteps))
        best, lnp = s.max_posterior()
        for i, name in enumerate(self.param_names):
            self.model.values[name] = float(best[i])
        if self._n_template:
            self.template.params = np.asarray(best[self.nparams:])
        if burn >= chain_len:
            import warnings

            warnings.warn(
                f"burn-in {burn} >= chain length {chain_len} (autocorr "
                "run converged early?); using chain_len//2 so the "
                "uncertainty sample stays meaningful")
            burn = chain_len // 2
        flat = s.flatchain(burn=burn)
        for i, name in enumerate(self.param_names):
            self.model.uncertainties[name] = float(flat[:, i].std())
        self.sampler = s
        return lnp


class MCMCFitterAnalyticTemplate(MCMCFitter):
    """Named variant requiring an analytic LCTemplate."""

    def __init__(self, toas, model, template, **kw):
        if isinstance(template, _BINNED):
            raise TypeError(
                "MCMCFitterAnalyticTemplate needs an LCTemplate; use "
                "MCMCFitterBinnedTemplate for binned profiles")
        super().__init__(toas, model, template, **kw)


class MCMCFitterBinnedTemplate(MCMCFitter):
    """Named variant requiring a binned profile array."""

    def __init__(self, toas, model, template, **kw):
        if not isinstance(template, _BINNED):
            raise TypeError(
                "MCMCFitterBinnedTemplate needs an array of bin heights; "
                "use MCMCFitterAnalyticTemplate for LCTemplate objects")
        super().__init__(toas, model, template, **kw)


class CompositeMCMCFitter:
    """Joint photon-likelihood MCMC over several event datasets sharing
    one timing model (pint_tpu mcmc_fitter.py:279): each dataset has its
    own template and weights; the timing parameters and their priors
    (counted once) are common."""

    def __init__(self, toas_list, model, templates, weights_list=None,
                 priors=None, width_sigma=10.0, device=None):
        if weights_list is None:
            weights_list = [None] * len(toas_list)
        if len(templates) != len(toas_list):
            raise ValueError("one template per dataset required")
        self.model = model
        self.device = resolve_device(device)
        self.fitters = [
            MCMCFitter(t, model, tpl, weights=w, priors=priors,
                       width_sigma=width_sigma, device=self.device)
            for t, tpl, w in zip(toas_list, templates, weights_list)]
        f0 = self.fitters[0]
        self.param_names = f0.param_names
        self.nparams = f0.nparams
        self.priors = f0.priors

    def lnposterior(self, vec):
        lnp = 0.0
        for i, name in enumerate(self.param_names):
            lnp = lnp + self.priors[name].lnpdf(vec[i])
        for f in self.fitters:
            lnp = lnp + f.lnlike_only(vec)
        return lnp

    def fit_toas(self, nwalkers=32, nsteps=500, seed=0, burn_frac=0.25):
        center = np.array([self.model.values[n] for n in self.param_names])
        scales = np.array(_scales(self.priors, self.param_names))
        s = EnsembleSampler(self.lnposterior, nwalkers=nwalkers, seed=seed,
                            device=self.device)
        x0 = s.initial_ball(center, scales)
        with torch.no_grad():
            s.run_mcmc(x0, nsteps)
        best, lnp = s.max_posterior()
        for i, name in enumerate(self.param_names):
            self.model.values[name] = float(best[i])
        flat = s.flatchain(burn=int(burn_frac * nsteps))
        for i, name in enumerate(self.param_names):
            self.model.uncertainties[name] = float(flat[:, i].std())
        self.sampler = s
        return lnp
