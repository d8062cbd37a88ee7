"""Export the photon case and its JAX CPU answers: one bright
Fermi-LAT-like millisecond pulsar timed from 10^5 weighted photons
(``pint_tpu.event_toas`` + ``pint_tpu.mcmc_fitter`` +
``pint_tpu.templates``), for the port's chip check and tests.

The case (all from one numpy seed):

- the par (:data:`PAR`): F0 ~ 300 Hz, F1, a DD binary (PB 5.2 d, fixed
  small ECC, so one Kepler depth serves the prior box), TZRSITE @, DM
  0; free F0, F1, PB, A1, T0 with uncertainties, which give the default
  priors (value +- 10 uncertainties);
- the template (:func:`true_template`): LCGaussian + LCLorentzian2 +
  LCVonMises, norms 0.25 + 0.2 + 0.15;
- the photons (:func:`simulate_photons`): a weight per photon from
  Beta(1, 3); with probability w the photon is pulsed and its phase is
  drawn by rejection from the template's density, its time then placed
  at that phase of the JAX model (a uniform time moved by three Newton
  steps on the model's phase); otherwise its time is uniform over the
  10 years.  Times are Fermi MET seconds (MJDREF 51910 +
  7.428703703703703e-4) in a barycentred (TDB, SOLARSYSTEM) event file
  with a WEIGHT column.

JAX's answers, loading the event file with ``load_Fermi_TOAs``:

- ``ticks_sha256``: the TOAs' int64 ticks, hashed; ``true_phases``: the
  TZR-referenced phases ``frac % 1`` at the par's values; ``hmw_true``:
  their weighted H-test;
- (a) ``a_*``: ``MCMCFitter(toas, model, template)`` sampled by
  ``EnsembleSampler(lnposterior, nwalkers=32, seed=0)`` for 200 steps
  from ``initial_ball`` (center and scales as ``fit_toas`` forms them):
  x0, the replayed draws (``tools/export_torch_mcmc_case.replay_draws``),
  chain, lnp, accept decisions, acceptance; (b) ``b_*``: the same with
  ``fit_template=True``;
- (c) lnposterior at a spread of vectors (the initial ball and the
  last positions) for (a), (b) and the binned fitter over a 64-bin
  profile of the template (``c_bins``);
- (d) ``lc_*``: ``LCFitter(start template, true_phases, weights)
  .fit()`` from a perturbed start: the final parameters, lnL, the
  L-BFGS iteration count, the Hessian's sigma, and lnlike and its
  gradient at the start and three perturbed points; ``lc_fits`` /
  ``lc_fits_lnlike``: JAX's fits with every evaluation perturbed by the
  port's measured disagreement, rounded up, one a seed of
  :data:`LC_SEEDS` (``tolerances.lcfit_limits``), from the sums
  ``lc_lnx_abs`` and ``lc_grad_abs``; ``lc_wrong`` / ``lc_wrong_lnlike``:
  its fits with one gradient entry wrong by :data:`LC_WRONG_REL` of its
  sum of |terms|, one an entry;
- the tolerance inputs: ``phase_diff_turns``, the largest difference of
  the port's phases (on the CPU) from JAX's over the photons, and
  ``lnx_abs_sum`` / ``dlnx_dphi_abs_sum``, sum_i |log x_i| and sum_i
  |d log x_i / d phi_i| at the par's values (x = w f + 1 - w).

Usage (from the repo root, ~10 min on 8 CPU cores)::

    JAX_PLATFORMS=cpu python tools/export_torch_photon_case.py \\
        --out pint_tpu_torch/data/photon_fermi_1e5.npz
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pint_tpu_torch.convert import (PHOTON_FERMI_1E5,  # noqa: E402
                                    template_to_arrays)
from tools.export_torch_case import _commit  # noqa: E402
from tools.export_torch_mcmc_case import (replay_draws,  # noqa: E402
                                          sampler_keys)

#: the pulsar: a 300 Hz MSP in a 5.2 d orbit, barycentred photons
PAR = """PSR J1234+5678
RAJ 12:34:00.0
DECJ +56:18:00.0
F0 300.123456789 1 1e-12
F1 -1.2e-15 1 1e-20
PEPOCH 56800
BINARY DD
PB 5.2 1 1e-9
A1 3.1 1 1e-6
T0 56800.3 1 3e-7
ECC 0.00002
OM 45.0
DM 0.0
TZRMJD 56800
TZRSITE @
TZRFRQ 0
UNITS TDB
EPHEM builtin
"""

MJDREF = (51910, 7.428703703703703e-4)  #: Fermi's MET reference
T_START_MJD, YEARS = 55000.0, 10.0
N_PHOTONS, SEED = 10**5, 19
NWALKERS, NSTEPS, NBINS = 32, 200, 64


def true_template():
    """The pulsar's light curve (pint_tpu templates)."""
    from pint_tpu.templates import (LCGaussian, LCLorentzian2, LCTemplate,
                                    LCVonMises)

    return LCTemplate([LCGaussian(sigma=0.04, loc=0.3),
                       LCLorentzian2(gamma1=0.05, gamma2=0.07, loc=0.55),
                       LCVonMises(kappa=30.0, loc=0.8)],
                      norms=[0.25, 0.2, 0.15])


def start_template():
    """The template fit's start: the true one with every peak moved by
    0.005 turns and its width and norm changed by ~10 %."""
    from pint_tpu.templates import (LCGaussian, LCLorentzian2, LCTemplate,
                                    LCVonMises)

    return LCTemplate([LCGaussian(sigma=0.045, loc=0.305),
                       LCLorentzian2(gamma1=0.055, gamma2=0.065, loc=0.545),
                       LCVonMises(kappa=27.0, loc=0.805)],
                      norms=[0.22, 0.18, 0.13])


def met_range():
    t0 = (T_START_MJD - MJDREF[0] - MJDREF[1]) * 86400.0
    return t0, t0 + YEARS * 365.25 * 86400.0


def write_fits(path, met, weights=None):
    from pint_tpu.fits import write_events

    extra = None if weights is None else {"WEIGHT": weights}
    write_events(path, met, mjdref=MJDREF, timesys="TDB",
                 timeref="SOLARSYSTEM", extra_cols=extra)


def jax_phases(model, met, tmpdir):
    """(n int64, frac float64) of the JAX model at MET seconds ``met``
    (TZR-referenced), through an event file and ``load_event_TOAs``."""
    from pint_tpu.event_toas import load_event_TOAs

    path = os.path.join(tmpdir, "phase.fits")
    write_fits(path, met)
    toas = load_event_TOAs(path, "fermi")
    prep = model.prepare(toas)
    n, frac = prep._phase_raw(prep._values_pytree())
    return np.asarray(n), np.asarray(frac)


def simulate_photons(model, template, n, seed, tmpdir):
    """(met (n,), weights (n,)) sorted by time: weights from Beta(1, 3);
    a photon is pulsed with probability w, its phase drawn from the
    template's density and its time placed there by three Newton steps
    on the JAX model's phase; the rest uniform in time."""
    rng = np.random.default_rng(seed)
    w = rng.beta(1.0, 3.0, n)
    pulsed = rng.uniform(size=n) < w
    lo, hi = met_range()
    met = rng.uniform(lo, hi, n)
    k = int(pulsed.sum())
    grid = np.linspace(0.0, 1.0, 20001)
    fmax = 1.01 * float(np.max(np.asarray(template.density(grid))))
    target = np.empty(0)
    while target.size < k:
        cand = rng.uniform(size=4 * k)
        u = rng.uniform(size=4 * k) * fmax
        keep = u < np.asarray(template.density(cand))
        target = np.concatenate([target, cand[keep]])
    target = target[:k]
    t = met[pulsed]
    f0 = float(model.values["F0"])
    for _ in range(3):
        _, frac = jax_phases(model, t, tmpdir)
        delta = (target - frac + 0.5) % 1.0 - 0.5
        t = t + delta / f0
    met[pulsed] = t
    order = np.argsort(met, kind="stable")
    return met[order], w[order]


def chain_answers(kind, fitter, model, template_params=None):
    """(a)/(b): the injected-draw chain of ``fitter`` and its records."""
    import jax
    import jax.numpy as jnp

    from pint_tpu.bayesian import UniformPrior
    from pint_tpu.sampler import EnsembleSampler

    names = list(fitter.param_names)
    center = np.array([model.values[n] for n in names]
                      + (list(template_params) if template_params
                         is not None else []))
    scales = [(fitter.priors[n].hi - fitter.priors[n].lo) / 100.0
              if isinstance(fitter.priors[n], UniformPrior)
              else fitter.priors[n].sigma for n in names]
    scales += [0.01] * (len(center) - len(names))
    s = EnsembleSampler(fitter.lnposterior, nwalkers=NWALKERS, seed=0)
    x0 = np.asarray(s.initial_ball(center, np.array(scales)))
    _, run_key = sampler_keys(0)
    t0 = time.time()
    s.run_mcmc(jnp.asarray(x0), NSTEPS)
    print(f"{kind}: run_mcmc {time.time() - t0:.1f} s, acceptance "
          f"{s.acceptance}", file=sys.stderr)
    chain = np.asarray(s.chain)
    path = np.concatenate([x0[None], chain])
    u, idx, u_acc = replay_draws(run_key, NSTEPS, NWALKERS // 2)
    spread = np.concatenate([x0, chain[-1]])
    lnpost = np.asarray(jax.jit(jax.vmap(fitter.lnposterior))(
        jnp.asarray(spread)))
    return {
        f"{kind}_param_names": np.asarray(names, dtype=np.str_),
        f"{kind}_x0": x0, f"{kind}_draw_u": u, f"{kind}_draw_idx": idx,
        f"{kind}_draw_uacc": u_acc, f"{kind}_chain": chain,
        f"{kind}_lnp": np.asarray(s.lnprob),
        f"{kind}_accepted": np.any(path[1:] != path[:-1], axis=-1),
        f"{kind}_acceptance": np.asarray(s.acceptance, np.float64),
        f"{kind}_spread_x": spread, f"{kind}_lnpost": lnpost,
    }


#: the seeds of JAX's perturbed template fits (``tolerances.lcfit_limits``)
LC_SEEDS = tuple(range(6))
#: the bias of the wrong gradient recorded beside them: entry k of
#: every gradient moved by LC_WRONG_REL S_k, one fit an entry
LC_WRONG_REL = 1e-5


def lc_sums(template, phases, weights, params):
    """(sum_i |log x_i|, S (P,) = sum_i |d log x_i / d theta_k|) of a JAX
    template at ``params``, x = w f + 1 - w (f without weights)."""
    import jax
    import jax.numpy as jnp

    phi = jnp.asarray(np.asarray(phases, np.float64) % 1.0)

    def lnx(p):
        f = template.density(phi, p)
        if weights is not None:
            w = jnp.asarray(weights)
            f = w * f + (1.0 - w)
        return jnp.log(jnp.maximum(f, 1e-300))

    p = jnp.asarray(np.asarray(params, np.float64))
    return (float(jnp.sum(jnp.abs(lnx(p)))),
            np.abs(np.asarray(jax.jacfwd(lnx)(p))).sum(axis=0))


def lc_fit(make_template, phases, weights, change=None):
    """JAX's ``LCFitter(make_template(), phases, weights).fit()``, each
    evaluation's (-lnL, gradient) passed through ``change`` first:
    (params, lnL)."""
    from pint_tpu.templates import LCFitter

    f = LCFitter(make_template(), phases, weights)
    if change is not None:
        inner = f._val_grad
        f._val_grad = lambda x: change(*inner(x))
    params, lnl = f.fit()
    return np.array(params), float(lnl)


def lc_perturbed_fits(make_template, phases, weights, lnx_abs, grad_abs,
                      seeds=LC_SEEDS):
    """(fits (S, P), lnL (S,)): JAX's template fit with every evaluation
    perturbed as ``tolerances.LCFIT_VALUE_REL`` / ``LCFIT_GRAD_REL`` say,
    one fit a seed (``lnx_abs``, ``grad_abs``: :func:`lc_sums`)."""
    from pint_tpu_torch import tolerances as tol

    fits, lnls = [], []
    for seed in seeds:
        rng = np.random.default_rng(seed)

        def change(v, g):
            xi = rng.standard_normal(1 + len(grad_abs))
            return (v + tol.LCFIT_VALUE_REL * lnx_abs * xi[0],
                    np.asarray(g) + tol.LCFIT_GRAD_REL * grad_abs * xi[1:])

        p, lnl = lc_fit(make_template, phases, weights, change)
        fits.append(p)
        lnls.append(lnl)
    return np.stack(fits), np.asarray(lnls)


def lc_wrong_fits(make_template, phases, weights, grad_abs,
                  rel=LC_WRONG_REL):
    """(fits (P, P), lnL (P,)): JAX's template fit with a wrong gradient,
    entry k of every evaluation's moved by ``rel`` S_k, one fit an
    entry."""
    fits, lnls = [], []
    for k in range(len(grad_abs)):
        def change(v, g, k=k):
            g = np.array(g)
            g[k] += rel * grad_abs[k]
            return v, g

        p, lnl = lc_fit(make_template, phases, weights, change)
        fits.append(p)
        lnls.append(lnl)
    return np.stack(fits), np.asarray(lnls)


def lcfit_answers(phases, weights):
    """(d): the template fit from :func:`start_template`, and JAX's fits
    under the perturbation behind its limit and under a wrong
    gradient."""
    import jax
    import jax.numpy as jnp
    import scipy.optimize

    from pint_tpu.templates import LCFitter
    from pint_tpu_torch import tolerances as tol

    inner = scipy.optimize.minimize
    nits = []

    def minimize(*a, **k):
        res = inner(*a, **k)
        nits.append(int(res.nit))
        return res

    start = np.array(start_template().params)
    t0 = time.time()
    f = LCFitter(start_template(), phases, weights)
    scipy.optimize.minimize = minimize
    try:
        params, lnl = f.fit()
    finally:
        scipy.optimize.minimize = inner
    params = np.array(params)
    print(f"lc fit: {time.time() - t0:.1f} s, {nits[-1]} iterations, "
          f"lnL {lnl!r}", file=sys.stderr)
    sigma = np.asarray(f.param_uncertainties())
    lnx_abs, grad_abs = lc_sums(start_template(), phases, weights, params)
    fits, fits_lnl = lc_perturbed_fits(start_template, phases, weights,
                                       lnx_abs, grad_abs)
    wrong, wrong_lnl = lc_wrong_fits(start_template, phases, weights,
                                     grad_abs)
    lim = tol.lcfit_limits(fits, fits_lnl, params, lnl, sigma)
    wmove = tol.lcfit_limits(wrong, wrong_lnl, params, lnl, sigma)["moves"]
    print(f"lc fit: perturbed fits move by {lim['moves'].tolist()} sigma "
          f"and lnL by {np.abs(fits_lnl - lnl).tolist()}; a wrong "
          f"gradient by {wmove.tolist()}; fraction {lim['fraction']!r}",
          file=sys.stderr)
    rng = np.random.default_rng(7)
    points = np.stack([start] + [params + 0.3 * sigma
                                 * rng.standard_normal(len(params))
                                 for _ in range(3)])
    fj = LCFitter(start_template(), phases, weights)
    vg = jax.jit(jax.value_and_grad(fj._lnlike))
    vals, grads = zip(*(vg(jnp.asarray(p)) for p in points))
    return {
        "lc_start": start, "lc_params": params,
        "lc_lnlike": np.asarray(lnl, np.float64),
        "lc_nit": np.asarray(nits[0]), "lc_sigma": sigma,
        "lc_fits": fits, "lc_fits_lnlike": fits_lnl,
        "lc_wrong": wrong, "lc_wrong_lnlike": wrong_lnl,
        "lc_lnx_abs": np.asarray(lnx_abs), "lc_grad_abs": grad_abs,
        "lc_points": points,
        "lc_point_lnlike": np.asarray(vals, np.float64),
        "lc_point_grad": np.asarray(grads, np.float64),
    }


def port_phase_diff(par_path, fits_path, frac_jax):
    """Largest |frac| difference of the port's phases (CPU) from JAX's
    at the par's values, in turns (both TZR-referenced, in [-0.5,
    0.5))."""
    import torch

    from pint_tpu_torch.event_toas import load_Fermi_TOAs
    from pint_tpu_torch.models.builder import get_model

    model = get_model(par_path)
    toas = load_Fermi_TOAs(fits_path)
    prep = model.prepare(toas, device="cpu")
    with torch.no_grad():
        _, frac = prep.phase()
    d = np.abs(frac.numpy() - frac_jax)
    return float(np.max(np.minimum(d, 1.0 - d)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(PHOTON_FERMI_1E5))
    ap.add_argument("--n", type=int, default=N_PHOTONS)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from pint_tpu.event_toas import load_Fermi_TOAs
    from pint_tpu.eventstats import hmw
    from pint_tpu.mcmc_fitter import MCMCFitter
    from pint_tpu.models.builder import get_model

    tmp = tempfile.mkdtemp(prefix="photon_case_")
    par = os.path.join(tmp, "psr.par")
    with open(par, "w") as f:
        f.write(PAR)
    model = get_model(par)
    template = true_template()
    t0 = time.time()
    met, weights = simulate_photons(model, template, args.n, SEED, tmp)
    print(f"simulate: {time.time() - t0:.1f} s", file=sys.stderr)
    fits = os.path.join(tmp, "events.fits")
    write_fits(fits, met, weights)
    t0 = time.time()
    toas = load_Fermi_TOAs(fits)
    print(f"load_Fermi_TOAs: {time.time() - t0:.1f} s", file=sys.stderr)
    ticks = np.ascontiguousarray(np.asarray(toas.ticks, np.int64))
    prep = model.prepare(toas)
    _, frac = prep._phase_raw(prep._values_pytree())
    frac = np.asarray(frac)
    phases = frac % 1.0
    out = {"par_text": np.asarray(PAR), "mjdref_i": np.asarray(MJDREF[0]),
           "mjdref_f": np.asarray(MJDREF[1]), "met": met,
           "weights": weights,
           "ticks_sha256": np.asarray(hashlib.sha256(
               ticks.tobytes()).hexdigest()),
           "true_phases": phases,
           "hmw_true": np.asarray(hmw(phases, weights), np.float64),
           "nwalkers": np.asarray(NWALKERS), "nsteps": np.asarray(NSTEPS),
           "commit": np.asarray(_commit())}
    out.update(template_to_arrays(template, "template"))
    out.update(template_to_arrays(start_template(), "start"))
    # the tolerance inputs at the par's values
    w = jnp.asarray(weights)

    def lnx(phi):
        f = template.density(phi)
        return jnp.log(jnp.maximum(w * f + (1.0 - w), 1e-300))

    out["lnx_abs_sum"] = np.asarray(float(jnp.sum(jnp.abs(lnx(
        jnp.asarray(phases))))))
    dphi = jax.grad(lambda p: jnp.sum(lnx(p)))(jnp.asarray(phases))
    out["dlnx_dphi_abs_sum"] = np.asarray(float(jnp.sum(jnp.abs(dphi))))
    out["phase_diff_turns"] = np.asarray(port_phase_diff(par, fits, frac))
    print(f"port phases differ by {float(out['phase_diff_turns'])!r} "
          "turns", file=sys.stderr)
    fa = MCMCFitter(toas, model, template)
    out.update(chain_answers("a", fa, model))
    fb = MCMCFitter(toas, model, true_template(), fit_template=True)
    out.update(chain_answers("b", fb, model, true_template().params))
    grid = (np.arange(NBINS) + 0.5) / NBINS
    bins = np.asarray(template.density(grid))
    fc = MCMCFitter(toas, model, bins)
    out["c_bins"] = bins
    out["c_lnpost"] = np.asarray(jax.jit(jax.vmap(fc.lnposterior))(
        jnp.asarray(out["a_spread_x"])))
    out.update(lcfit_answers(phases, weights))
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes): "
          + json.dumps({"hmw_true": float(out["hmw_true"]),
                        "a_acceptance": float(out["a_acceptance"]),
                        "b_acceptance": float(out["b_acceptance"])}),
          file=sys.stderr)


if __name__ == "__main__":
    main()
