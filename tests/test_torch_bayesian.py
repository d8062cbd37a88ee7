"""The port's Bayesian timing posterior (``pint_tpu_torch.bayesian``) and
``Residuals.lnlikelihood_at`` against pint_tpu's on the CPU, the twin of
tests/test_bayesian.py.

The case is the 400-TOA B1855-like par/tim of tests/test_torch_wls.py,
fitted by JAX's ``GLSFitter``; its posterior (``gls``: ECORR and red
noise fixed, the correlated likelihood) and that of the par without its
correlated noise at the same values and uncertainties (``wls``: the
white likelihood).  The port's posteriors are built at JAX's fitted
values and uncertainties, so both packages hold the same priors.

- ``lnlikelihood_at`` and ``lnposterior`` at 16 walkers (JAX's initial
  ball and a ball of 0.3 uncertainties) within
  ``tolerances.mcmc_lnp_limit``, NaN where JAX's is NaN; the posterior
  peaked at the fit;
- the one-factor form (``woodbury_precompute`` + K8's plain version)
  against the per-walker capacity Cholesky, within the same limit;
- ``prior_transform`` round trips, explicit normal priors against JAX's
  ``ndtri``, a raise without uncertainties, ``wideband=True`` raising;
- the gradient by ``torch.func.jacfwd`` (white posterior; correlated in
  the per-walker form) against ``jax.grad``; through K8 it raises;
- an 8-walker x 20-step chain on the GLS posterior with JAX's draws
  injected: up to the first near tie (``tolerances.near_ties``; none
  here) positions bit-identical, every decision the same, lnp within
  the limit;
- ``sample`` from the generator sets the model to the max-posterior
  walker.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu.bayesian import BayesianTiming as JBayesianTiming
from pint_tpu.fitter import GLSFitter as JGLSFitter
from pint_tpu.models.builder import get_model_and_toas as jget_mt
from pint_tpu.sampler import EnsembleSampler as JEnsembleSampler
from pint_tpu_torch import tolerances as tol
from pint_tpu_torch.bayesian import BayesianTiming, NormalPrior
from pint_tpu_torch.models.builder import get_model_and_toas
from pint_tpu_torch.sampler import decision_margins, run_chain
from tests.test_torch_wls import par_tim  # noqa: F401  (fixture)
from tools.export_torch_grid_case import white_par
from tools.export_torch_mcmc_case import replay_draws, sampler_keys

# one intra-op thread: the tests run at small sizes, and pytest-xdist's
# workers share the machine's cores (torch's default of one thread per
# core in every worker oversubscribes them several times over)
torch.set_num_threads(1)

NW = 8


@pytest.fixture(scope="module")
def posts(par_tim):  # noqa: F811
    par, tim = par_tim
    white = Path(par).with_name("white.par")
    white.write_text(white_par(Path(par).read_text()))
    out = {}
    fit = None
    for kind, p in (("gls", par), ("wls", str(white))):
        jm, jt = jget_mt(p, tim)
        if fit is None:
            JGLSFitter(jt, jm).fit_toas(maxiter=3)
            fit = {n: (jm.values[n], jm.params[n].uncertainty)
                   for n in jm.free_params}
        else:  # the white posterior at the GLS fit's values and priors
            for n, (v, u) in fit.items():
                jm.values[n] = v
                jm.params[n].uncertainty = u
        jbt = JBayesianTiming(jm, jt)
        model, toas = get_model_and_toas(p, tim)
        for n in jbt.param_names:
            model.values[n] = float(jm.values[n])
            model.uncertainties[n] = float(jm.params[n].uncertainty)
        bt = BayesianTiming(model, toas, device="cpu")
        s = JEnsembleSampler(jbt.lnposterior, nwalkers=NW, seed=0)
        ball = np.asarray(s.initial_ball(jbt.start_vector(),
                                         jbt.scale_vector()))
        rng = np.random.default_rng(3)
        tight = jbt.start_vector() + 0.3 * jbt.scale_vector() \
            * rng.standard_normal((NW, jbt.nparams))
        out[kind] = {"jbt": jbt, "bt": bt, "model": model, "toas": toas,
                     "x": np.concatenate([ball, tight]), "tight": tight}
    return out


def _jlnpost(jbt, x):
    return np.asarray(jax.jit(jax.vmap(jbt.lnposterior))(jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["gls", "wls"])
def test_lnlikelihood_at_matches_jax(posts, kind):
    p = posts[kind]
    jbt, bt = p["jbt"], p["bt"]
    data = jbt.resids._data()
    ref = np.asarray(jax.jit(jax.vmap(lambda v: jbt.resids.lnlikelihood_at(
        jbt._values_of(v), data)))(jnp.asarray(p["tight"])))
    got = torch.func.vmap(lambda v: bt.resids.lnlikelihood_at(
        bt._values_of(v)))(torch.tensor(p["tight"])).numpy()
    assert np.all(np.isfinite(ref))
    assert tol.mcmc_lnp_ok(got, ref), np.abs(got - ref)
    assert bt.resids.lnlikelihood() == pytest.approx(float(
        jbt.resids.lnlikelihood()), rel=0, abs=float(tol.mcmc_lnp_limit(
            jbt.resids.lnlikelihood())))


@pytest.mark.parametrize("kind", ["gls", "wls"])
def test_lnposterior_matches_jax(posts, kind):
    p = posts[kind]
    jbt, bt = p["jbt"], p["bt"]
    ref = _jlnpost(jbt, p["x"])
    got = torch.func.vmap(bt.lnposterior)(torch.tensor(p["x"])).numpy()
    assert np.any(np.isfinite(ref))
    assert tol.mcmc_lnp_ok(got, ref), np.abs(got - ref)
    # peaked at the fit: 5 uncertainties off in F0 is lower
    v0 = torch.tensor(bt.start_vector())
    dv = torch.zeros(bt.nparams, dtype=torch.float64)
    dv[bt.param_names.index("F0")] = 5 * bt.scale_vector()[
        bt.param_names.index("F0")]
    assert float(bt.lnposterior(v0 + dv)) < float(bt.lnposterior(v0))


def _per_walker(bt):
    """The posterior with the reference's per-walker likelihood: a
    capacity Cholesky per call (``Residuals.lnlikelihood_at``)."""
    return lambda v: bt.lnprior(v) + bt.resids.lnlikelihood_at(
        bt._values_of(v))


@pytest.mark.parametrize("kind", ["gls", "wls"])
def test_one_factor_form_matches_per_walker(posts, kind):
    p = posts[kind]
    bt = p["bt"]
    assert (bt._pre is not None) == (kind == "gls")
    assert (bt._white is not None) == (kind == "wls")
    x = torch.tensor(p["x"])
    a = torch.func.vmap(bt.lnposterior)(x).numpy()
    b = np.array([float(_per_walker(bt)(v)) for v in x])
    assert tol.mcmc_lnp_ok(a, b), np.abs(a - b)


def test_prior_transform_roundtrip(posts):
    jbt, bt = posts["gls"]["jbt"], posts["gls"]["bt"]
    mid = bt.prior_transform(torch.full((bt.nparams,), 0.5,
                                        dtype=torch.float64))
    np.testing.assert_allclose(mid.numpy(), bt.start_vector(), rtol=1e-12)
    cube = np.random.default_rng(5).uniform(size=bt.nparams)
    np.testing.assert_allclose(
        bt.prior_transform(torch.tensor(cube)).numpy(),
        np.asarray(jbt.prior_transform(jnp.asarray(cube))), rtol=1e-15)
    lo = bt.prior_transform(torch.zeros(bt.nparams, dtype=torch.float64))
    assert float(bt.lnprior(lo)) == pytest.approx(float(
        jbt.lnprior(jnp.asarray(lo.numpy()))), rel=1e-15)
    outside = lo - 1e-3 * torch.tensor(bt.scale_vector())
    assert float(bt.lnprior(outside)) == -np.inf


def test_explicit_priors(posts):
    p = posts["wls"]
    m = p["model"]
    pri = {n: NormalPrior(float(m.values[n]), 1.0) for n in m.free_params}
    bt = BayesianTiming(m, p["toas"], priors=pri, device="cpu")
    u = bt.prior_transform(torch.full((bt.nparams,), 0.975,
                                      dtype=torch.float64)).numpy()
    np.testing.assert_allclose(u - bt.start_vector(), 1.9599, atol=1e-3)
    from pint_tpu.bayesian import NormalPrior as JNormalPrior

    jbt = JBayesianTiming(p["jbt"].model, p["jbt"].toas, priors={
        n: JNormalPrior(float(m.values[n]), 1.0) for n in m.free_params})
    ju = np.asarray(jbt.prior_transform(jnp.full(bt.nparams, 0.975)))
    np.testing.assert_allclose(u, ju, rtol=1e-15)
    x = torch.tensor(u) + 0.1
    assert float(bt.lnprior(x)) == pytest.approx(
        float(jbt.lnprior(jnp.asarray(x.numpy()))), rel=1e-14)


def test_requires_priors_without_uncertainty(par_tim):  # noqa: F811
    model, toas = get_model_and_toas(*par_tim)
    assert not model.uncertainties
    with pytest.raises(ValueError, match="prior"):
        BayesianTiming(model, toas, device="cpu")
    with pytest.raises(NotImplementedError, match="wideband"):
        BayesianTiming(model, toas, device="cpu", wideband=True)


@pytest.mark.parametrize("kind", ["gls", "wls"])
def test_gradient_matches_jax(posts, kind):
    """jacfwd of the port's posterior against jax.grad of JAX's at a
    walker off the peak: the white posterior as it samples, the
    correlated one in its per-walker form (K8 has no derivative rule,
    so through the one-factor form the gradient raises)."""
    p = posts[kind]
    jbt, bt = p["jbt"], p["bt"]
    x = p["tight"][0]
    ref = np.asarray(jax.jit(jax.grad(jbt.lnposterior))(jnp.asarray(x)))
    lnpost = bt.lnposterior if kind == "wls" else _per_walker(bt)
    got = torch.func.jacfwd(lnpost)(torch.tensor(x)).numpy()
    assert np.all(np.isfinite(ref))
    assert tol.vector_rel(got * jbt.scale_vector(),
                          ref * jbt.scale_vector()) <= 1e-6
    if kind == "gls":
        with pytest.raises(NotImplementedError, match="K8"):
            torch.func.jacfwd(bt.lnposterior)(torch.tensor(x))


def test_gls_chain_with_injected_draws_matches_jax(posts):
    p = posts["gls"]
    jbt, bt = p["jbt"], p["bt"]
    nsteps = 20
    s = JEnsembleSampler(jbt.lnposterior, nwalkers=NW, seed=0)
    x0 = np.asarray(s.initial_ball(jbt.start_vector(), jbt.scale_vector()))
    s.run_mcmc(x0, nsteps)
    chain, lnp = np.asarray(s.chain), np.asarray(s.lnprob)
    _, run_key = sampler_keys(0)
    draws = replay_draws(run_key, nsteps, NW // 2)
    out = run_chain(bt.lnposterior, x0, nsteps, device="cpu", draws=draws)
    margin, lnp_prop, before = decision_margins(out, draws)
    tie = tol.near_ties(margin, lnp_prop, before).any(axis=(1, 2))
    upto = int(np.argmax(tie)) if tie.any() else nsteps
    assert upto == nsteps  # no near tie on this chain
    path = np.concatenate([x0[None], chain])
    accepted = np.any(path[1:] != path[:-1], axis=-1)
    assert 0 < accepted.sum() < accepted.size
    assert np.array_equal(out["accepted"][:upto], accepted[:upto])
    assert np.all(np.abs(out["chain"][:upto] - chain[:upto])
                  <= tol.MCMC_POSITION_ULPS * np.spacing(np.abs(chain[:upto])))
    assert tol.mcmc_lnp_ok(out["lnp"][:upto], lnp[:upto])


def test_sample_sets_max_posterior(posts):
    p = posts["wls"]
    model = copy.deepcopy(p["model"])
    bt = BayesianTiming(model, p["toas"], device="cpu")
    flat, s = bt.sample(nwalkers=NW, nsteps=8, seed=2, burn_frac=0.25)
    assert flat.shape == (NW * 6, bt.nparams)
    best, lnp = s.max_posterior()
    assert [model.values[n] for n in bt.param_names] == list(best)
    assert lnp == float(np.nanmax(s.lnprob))
