"""Export the JAX CPU answers of the Bayesian timing posterior's ensemble
chains (``pint_tpu.bayesian`` + ``pint_tpu.sampler``) on the committed
10k-TOA par/tim case, for the port's chip check to be held to.

Two posteriors, each ``BayesianTiming(model, toas)`` over the 10 free
timing parameters of a fitted model (default priors: value +- 10
uncertainties), sampled by ``EnsembleSampler(lnposterior, nwalkers=32,
seed=0)`` from ``initial_ball(start_vector(), scale_vector())`` for 200
steps (the shape of ``bench.py:452``):

- ``gls``: ``pint_tpu_torch/data/b1855_like.par`` fitted by
  ``GLSFitter`` (maxiter=3); EFAC/EQUAD, ECORR and 30-mode red noise
  fixed, so the correlated likelihood;
- ``wls``: ``b1855_white.par`` fitted by ``WLSFitter`` (maxiter=3); the
  white likelihood.

Written arrays, per posterior ``<k>``:

- ``<k>_param_names``, ``<k>_values``, ``<k>_uncertainties``: the fit's
  free parameters, in order, with JAX's fitted values and
  uncertainties (the port's posterior is built at these bits);
- ``<k>_kepler_iters``: the Newton depth of the Kepler solve that
  ``prepare`` chose for the posterior, and ``<k>_ecc_box``: the prior
  box of ECC (its depth class holds across the box);
- ``<k>_x0`` (32, 10): the initial ball;
- ``<k>_draw_u``, ``<k>_draw_idx``, ``<k>_draw_uacc`` (200, 2, 16): the
  random numbers of every half-move, replayed from the key splits of
  ``EnsembleSampler`` (sampler.py:350, :362, :368), ``run_mcmc``
  (:309, :269) and ``_stretch_half`` (:210-218);
- ``<k>_chain`` (200, 32, 10), ``<k>_lnp`` (200, 32),
  ``<k>_acceptance``: JAX's chain, and ``<k>_accepted`` (200, 32), its
  accept decisions (a move is accepted iff the walker moved);
- ``<k>_spread_x`` (64, 10): the initial ball and the chain's last
  positions, with JAX's lnposterior there in two forms,
  ``<k>_lnpost_cho`` (``BayesianTiming.lnposterior``: a capacity
  Cholesky per walker) and ``<k>_lnpost_pre`` (one
  ``woodbury_precompute`` factor, ``woodbury_chi2_logdet_pre`` per
  walker; for the white posterior sigma computed once): their
  difference, and the chain's lnp against ``<k>_lnpost_cho`` at the
  last positions, are the reference's own movement, which
  ``pint_tpu_torch/tolerances.py`` sets the lnp limit beside;
- the commit.

Before it exports, the tool checks its draw replay: a chain over a
Gaussian target driven by the replayed draws through a copy of
``_stretch_half``'s lines must equal JAX's own ``run_mcmc`` chain bit for
bit.

Usage (from the repo root, ~2 min on 8 CPU cores)::

    JAX_PLATFORMS=cpu python tools/export_torch_mcmc_case.py
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pint_tpu_torch.convert import (B1855_MCMC_ANSWERS,  # noqa: E402
                                    B1855_PAR, B1855_TIM, B1855_WHITE_PAR)
from tools.export_torch_case import _commit  # noqa: E402

NWALKERS, NSTEPS, SEED = 32, 200, 0


def replay_draws(key, nsteps, half):
    """(u, idx, u_acc), each (nsteps, 2, half): the numbers
    ``pint_tpu.sampler.run_mcmc(key=key)`` draws, from the same splits:
    a key per step, two per step (one per half), three per half-move."""
    import jax

    us, idxs, uas = [], [], []
    for k in jax.random.split(key, nsteps):
        row = ([], [], [])
        for kh in jax.random.split(k):
            k_z, k_idx, k_acc = jax.random.split(kh, 3)
            row[0].append(np.asarray(jax.random.uniform(k_z, (half,))))
            row[1].append(np.asarray(jax.random.randint(
                k_idx, (half,), 0, half)))
            row[2].append(np.asarray(jax.random.uniform(k_acc, (half,))))
        us.append(row[0])
        idxs.append(row[1])
        uas.append(row[2])
    return (np.asarray(us), np.asarray(idxs).astype(np.int64),
            np.asarray(uas))


def sampler_keys(seed):
    """(the key of ``initial_ball``'s normal draw, the key ``run_mcmc``
    is given) of ``EnsembleSampler(seed=seed)``, called in that order."""
    import jax

    key = jax.random.PRNGKey(seed)
    key, ball = jax.random.split(key)
    key, run = jax.random.split(key)
    return ball, run


def chain_from_draws(lnpost, x0, draws, a=2.0):
    """The red-black chain of ``run_mcmc`` with injected draws, through a
    copy of ``_stretch_half``'s lines (pint_tpu sampler.py:211-220)."""
    import jax
    import jax.numpy as jnp

    lnpost_v = jax.vmap(lnpost)

    @jax.jit
    def half_move(active, other, lnp_active, u, idx, u_acc):
        ndim = active.shape[1]
        z = ((a - 1.0) * u + 1.0) ** 2 / a
        proposal = other[idx] + z[:, None] * (active - other[idx])
        lnp_prop = lnpost_v(proposal)
        lnratio = (ndim - 1.0) * jnp.log(z) + lnp_prop - lnp_active
        accept = jnp.log(u_acc) < lnratio
        return (jnp.where(accept[:, None], proposal, active),
                jnp.where(accept, lnp_prop, lnp_active))

    x = jnp.asarray(x0)
    h = x.shape[0] // 2
    lnp = jax.jit(lnpost_v)(x)
    chain = []
    for s in range(draws[0].shape[0]):
        first, lnp1 = half_move(x[:h], x[h:], lnp[:h],
                                *(d[s, 0] for d in draws))
        second, lnp2 = half_move(x[h:], first, lnp[h:],
                                 *(d[s, 1] for d in draws))
        x = jnp.concatenate([first, second])
        lnp = jnp.concatenate([lnp1, lnp2])
        chain.append(np.asarray(x))
    return np.asarray(chain)


def check_replay():
    """The replayed draws drive a copy of the half-move to JAX's own
    chain, bit for bit, on a 3-d Gaussian."""
    import jax
    import jax.numpy as jnp

    from pint_tpu.sampler import run_mcmc

    mu = jnp.array([1.0, -2.0, 0.5])
    sig = jnp.array([0.5, 2.0, 1.0])

    def lnpost(x):
        return -0.5 * jnp.sum(((x - mu) / sig) ** 2)

    key = jax.random.PRNGKey(42)
    x0 = np.asarray(mu + 0.1 * jax.random.normal(key, (8, 3)))
    chain, _, _ = run_mcmc(lnpost, x0, 50, key=key)
    mine = chain_from_draws(lnpost, x0, replay_draws(key, 50, 4))
    if not np.array_equal(np.asarray(chain), mine):
        raise AssertionError("replayed draws do not reproduce run_mcmc")
    print("replay check: 8 walkers x 50 steps bit-identical",
          file=sys.stderr)


def kepler_iters(prepared):
    """The Newton depth of the prepared model's Kepler solve (None
    without a binary)."""
    for sub in prepared.ctx.values():
        if isinstance(sub, dict) and "kepler_iters" in sub:
            return int(sub["kepler_iters"])
    return None


def pre_lnposterior(bt):
    """JAX's lnposterior with the noise factor built once: a
    ``woodbury_precompute`` factor (correlated) or sigma (white)."""
    import jax.numpy as jnp

    from pint_tpu.linalg import woodbury_chi2_logdet_pre, woodbury_precompute

    res = bt.resids
    sigma = res.sigma_fn(bt._base)
    n = res.n_real
    if bt.model.has_correlated_errors:
        U, phi = res._noise_basis_phi(bt._base)
        pre = woodbury_precompute(sigma, U, phi)

        def chi2_logdet(r):
            return woodbury_chi2_logdet_pre(r, pre)
    else:
        logdet_w = 2.0 * jnp.sum(jnp.log(sigma))

        def chi2_logdet(r):
            return jnp.sum((r / sigma) ** 2), logdet_w

    def lnpost(vec):
        chi2, logdet = chi2_logdet(res.time_resids_fn(bt._values_of(vec)))
        return bt.lnprior(vec) + (-0.5 * (chi2 + logdet)
                                  - 0.5 * n * jnp.log(2.0 * jnp.pi))
    return lnpost


def posterior_answers(kind, par, fitter_cls):
    import jax
    import jax.numpy as jnp

    from pint_tpu.bayesian import BayesianTiming
    from pint_tpu.models.builder import get_model_and_toas
    from pint_tpu.sampler import EnsembleSampler

    t0 = time.time()
    model, toas = get_model_and_toas(str(par), str(B1855_TIM))
    fitter_cls(toas, model).fit_toas(maxiter=3)
    bt = BayesianTiming(model, toas)
    names = list(bt.param_names)
    print(f"{kind}: fit + posterior {time.time() - t0:.1f} s", file=sys.stderr)
    s = EnsembleSampler(bt.lnposterior, nwalkers=NWALKERS, seed=SEED)
    x0 = s.initial_ball(bt.start_vector(), bt.scale_vector())
    _, run_key = sampler_keys(SEED)
    t0 = time.time()
    s.run_mcmc(x0, NSTEPS)
    print(f"{kind}: run_mcmc {time.time() - t0:.1f} s, acceptance "
          f"{s.acceptance}", file=sys.stderr)
    chain = np.asarray(s.chain)
    path = np.concatenate([np.asarray(x0)[None], chain])
    accepted = np.any(path[1:] != path[:-1], axis=-1)
    u, idx, u_acc = replay_draws(run_key, NSTEPS, NWALKERS // 2)
    spread_x = np.concatenate([np.asarray(x0), chain[-1]])
    lnpost_cho = np.asarray(jax.jit(jax.vmap(bt.lnposterior))(
        jnp.asarray(spread_x)))
    lnpost_pre = np.asarray(jax.jit(jax.vmap(pre_lnposterior(bt)))(
        jnp.asarray(spread_x)))
    lo, hi = bt.priors["ECC"].lo, bt.priors["ECC"].hi
    d = np.abs(lnpost_cho - lnpost_pre)
    print(f"{kind}: |cho - pre| lnposterior max {np.nanmax(d)!r}, "
          f"finite {np.isfinite(d).sum()} of {d.size}", file=sys.stderr)
    return {
        f"{kind}_param_names": np.asarray(names, dtype=np.str_),
        f"{kind}_values": np.asarray([model.values[n] for n in names],
                                     np.float64),
        f"{kind}_uncertainties": np.asarray(
            [model.params[n].uncertainty for n in names], np.float64),
        f"{kind}_kepler_iters": np.asarray(kepler_iters(bt.prepared)),
        f"{kind}_ecc_box": np.asarray([lo, hi], np.float64),
        f"{kind}_x0": np.asarray(x0),
        f"{kind}_draw_u": u, f"{kind}_draw_idx": idx,
        f"{kind}_draw_uacc": u_acc,
        f"{kind}_chain": chain, f"{kind}_lnp": np.asarray(s.lnprob),
        f"{kind}_acceptance": np.asarray(s.acceptance, np.float64),
        f"{kind}_accepted": accepted,
        f"{kind}_spread_x": spread_x, f"{kind}_lnpost_cho": lnpost_cho,
        f"{kind}_lnpost_pre": lnpost_pre,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(B1855_MCMC_ANSWERS))
    args = ap.parse_args(argv)

    from pint_tpu.fitter import GLSFitter, WLSFitter

    check_replay()
    out = {"nwalkers": np.asarray(NWALKERS), "nsteps": np.asarray(NSTEPS),
           "seed": np.asarray(SEED), "commit": np.asarray(_commit())}
    out.update(posterior_answers("gls", B1855_PAR, GLSFitter))
    out.update(posterior_answers("wls", B1855_WHITE_PAR, WLSFitter))
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)",
          file=sys.stderr)


if __name__ == "__main__":
    main()
