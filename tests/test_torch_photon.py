"""The photon path of the port (``pint_tpu_torch.fits``, ``event_toas``,
``eventstats``, ``mcmc_fitter``) against pint_tpu's on the CPU.

A 2000-photon case of ``tools/export_torch_photon_case.py`` (the 300 Hz
DD pulsar, its three-peak template, Beta(1, 3) weights, times placed at
the JAX model's phases), written as an event file by pint_tpu:

- the FITS writer's bytes and reader's columns, and the event TOAs'
  ticks, weights and rows, identical to pint_tpu's (with an energy cut
  on a NICER file too);
- ``eventstats`` equal;
- the analytic, ``fit_template``, binned and composite posteriors, and
  one over a primitive K12 does not cover (the CPU's loop), at a spread
  of vectors within ``tolerances.photon_lnlike_limit``;
- the analytic and ``fit_template`` chains, 8 walkers x 20 steps with
  JAX's draws, bit-identical up to the first near tie decided
  otherwise, lnp within the limit;
- a spy counts one plain K12 call per vmapped posterior call at 8 and
  at 2 walkers;
- ``fit_toas`` writes the max-posterior values and the spread, and the
  entry points run on CUDA unless given the CPU.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import pint_tpu.eventstats as jstats
import pint_tpu_torch.eventstats as tstats
import pint_tpu_torch.templates as tt
from pint_tpu.event_toas import load_event_TOAs as jload_event
from pint_tpu.event_toas import load_Fermi_TOAs as jload_fermi
from pint_tpu.event_toas import met_to_day_ns as jmet_to_day_ns
from pint_tpu.fits import read_events as jread_events
from pint_tpu.fits import write_events as jwrite_events
from pint_tpu.mcmc_fitter import CompositeMCMCFitter as JComposite
from pint_tpu.mcmc_fitter import MCMCFitter as JMCMCFitter
from pint_tpu.models.builder import get_model as jget_model
from pint_tpu.sampler import EnsembleSampler as JSampler
from pint_tpu_torch import tolerances as tol
from pint_tpu_torch.convert import template_from_arrays, template_to_arrays
from pint_tpu_torch.event_toas import load_event_TOAs, load_Fermi_TOAs
from pint_tpu_torch.event_toas import met_to_day_ns
from pint_tpu_torch.fits import read_events, write_events
from pint_tpu_torch.mcmc_fitter import CompositeMCMCFitter, MCMCFitter
from pint_tpu_torch.models.builder import get_model
from pint_tpu_torch.sampler import decision_margins, run_chain
from tools import export_torch_photon_case as case
from tools.export_torch_mcmc_case import replay_draws, sampler_keys

# one intra-op thread: the tests run at small sizes, and pytest-xdist's
# workers share the machine's cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
N, NW, NS = 2000, 8, 20


@pytest.fixture(scope="module")
def photons(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("photons"))
    par = os.path.join(d, "psr.par")
    with open(par, "w") as f:
        f.write(case.PAR)
    jmodel = jget_model(par)
    met, w = case.simulate_photons(jmodel, case.true_template(), N, 3, d)
    fits = os.path.join(d, "events.fits")
    case.write_fits(fits, met, w)
    return {"dir": d, "par": par, "fits": fits, "met": met, "w": w,
            "jtoas": jload_fermi(fits), "toas": load_Fermi_TOAs(fits)}


def _fitters(photons, kind):
    """(JAX fitter, the port's) of ``kind``: analytic, template, binned."""
    jmodel, model = jget_model(photons["par"]), get_model(photons["par"])
    jtpl = case.true_template()
    if kind == "uncovered":  # a primitive K12 does not cover: the CPU loop
        from pint_tpu.templates import LCGaussian, LCKing, LCTemplate

        jtpl = LCTemplate([LCGaussian(0.04, 0.3), LCKing(0.05, 3.0, 0.7)],
                          norms=[0.3, 0.2])
    if kind == "binned":
        jtpl = np.asarray(jtpl.density((np.arange(64) + 0.5) / 64))
        ttpl = np.array(jtpl)
    else:
        ttpl = template_from_arrays(template_to_arrays(jtpl))
    kw = {"fit_template": True} if kind == "template" else {}
    return (JMCMCFitter(photons["jtoas"], jmodel, jtpl, **kw),
            MCMCFitter(photons["toas"], model, ttpl, device=CPU, **kw))


def _limit(f, x):
    """photon_lnlike_limit at the port's fitter ``f`` and vector ``x``:
    sum |log x_i| from the port's density, the phases identical on one
    host (the fold repeats JAX's arithmetic)."""
    with torch.no_grad():
        frac = f._frac(torch.tensor(x))
        if f._packed is None:
            s = tt.photon_log_terms(f.template.density(
                torch.remainder(frac, 1.0)), f.weights).abs().sum()
        else:
            packed = f._pack(torch.tensor(x[f.nparams:])) \
                if f._n_template else f._packed
            s = tt.photon_lnlike_plain(frac[None], f.weights, *packed,
                                       bins=f._bins, wrap=True,
                                       absolute=True)
    return tol.photon_lnlike_limit(frac.shape[-1], float(s))


def test_fits_roundtrip_matches_jax(photons):
    a, b = (os.path.join(photons["dir"], n) for n in ("a.fits", "b.fits"))
    kw = dict(mjdref=(51910, 7.428703703703703e-4),
              extra_cols={"WEIGHT": photons["w"], "PI": photons["w"] * 100},
              extra_header={"TELESCOP": "GLAST"}, timezero=0.25)
    write_events(a, photons["met"], **kw)
    jwrite_events(b, photons["met"], **kw)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    h, d = read_events(a)
    jh, jd = jread_events(a)
    assert h == jh and d.keys() == jd.keys()
    assert all(np.array_equal(d[k], jd[k]) for k in d)


def test_event_toas_identical(photons):
    toas, jtoas = photons["toas"], photons["jtoas"]
    assert np.array_equal(toas.ticks, np.asarray(jtoas.ticks))
    assert toas.get_flag_values("weight") == jtoas.get_flag_values("weight")
    assert np.array_equal(toas.fits_rows, jtoas.fits_rows)
    assert np.array_equal(
        np.array(toas.get_flag_values("weight", astype=float)),
        photons["w"])
    # a NICER file (TT, geocentric) with an energy cut on PI
    path = os.path.join(photons["dir"], "nicer.fits")
    pi = np.linspace(20, 1200, N)
    write_events(path, photons["met"][::-1] % 1e7 + 1e8,
                 mjdref=(56658, 7.775925925925930e-4), timesys="TT",
                 timeref="GEOCENTRIC", extra_cols={"PI": pi})
    got = load_event_TOAs(path, "nicer", energy_range_kev=(0.5, 8.0))
    want = jload_event(path, "nicer", energy_range_kev=(0.5, 8.0))
    assert np.array_equal(got.ticks, np.asarray(want.ticks))
    assert np.array_equal(got.fits_rows, want.fits_rows)
    for t in (0.0, 1.5e8 + 0.123456789, -3.25):
        assert met_to_day_ns(0.000777, t, 0.5) == \
            jmet_to_day_ns(0.000777, t, 0.5)


def test_eventstats_equal(photons):
    ph = (photons["met"] * 300.0) % 1.0
    w = photons["w"]
    assert np.array_equal(tstats.z2m(ph, m=4, weights=w),
                          jstats.z2m(ph, m=4, weights=w))
    assert tstats.hm(ph) == jstats.hm(ph)
    assert tstats.hmw(ph, w) == jstats.hmw(ph, w)
    assert tstats.sf_z2m(11.0, 2) == jstats.sf_z2m(11.0, 2)
    assert tstats.sf_hm(30.0) == jstats.sf_hm(30.0)
    assert tstats.sig2sigma(1e-9) == jstats.sig2sigma(1e-9)
    assert tstats.sigma2sig(5.0) == jstats.sigma2sig(5.0)


def _ball(jf, model, nwalkers=NW, template=None):
    """JAX's initial ball for ``jf`` (fit_toas's center and scales)."""
    from pint_tpu.bayesian import UniformPrior

    names = jf.param_names
    center = np.array([model.values[n] for n in names]
                      + ([] if template is None else list(template)))
    scales = [(jf.priors[n].hi - jf.priors[n].lo) / 100.0
              if isinstance(jf.priors[n], UniformPrior) else jf.priors[n].sigma
              for n in names] + [0.01] * (len(center) - len(names))
    s = JSampler(jf.lnposterior, nwalkers=nwalkers, seed=0)
    return s, np.asarray(s.initial_ball(center, np.array(scales)))


@pytest.mark.parametrize("kind", ["analytic", "template", "binned",
                                  "uncovered"])
def test_posterior_matches_jax(photons, kind):
    jf, f = _fitters(photons, kind)
    tpl = case.true_template().params if kind == "template" else None
    _, x = _ball(jf, jf.model, 2 * NW, tpl)
    want = np.asarray(jax.vmap(jf.lnposterior)(jnp.asarray(x)))
    with torch.no_grad():
        got = torch.func.vmap(f.lnposterior)(torch.tensor(x)).numpy()
    assert np.all(np.isfinite(want))
    lims = np.array([_limit(f, xi) for xi in x])
    assert np.all(np.abs(got - want) <= lims)


def test_composite_posterior_matches_jax(photons):
    jmodel, model = jget_model(photons["par"]), get_model(photons["par"])
    half = len(photons["met"]) // 2
    jt_list = [photons["jtoas"][:half], photons["jtoas"][half:]]
    t_list = [photons["toas"][:half], photons["toas"][half:]]
    jtpl = case.true_template()
    bins = np.asarray(jtpl.density((np.arange(32) + 0.5) / 32))
    jc = JComposite(jt_list, jmodel, [jtpl, bins])
    c = CompositeMCMCFitter(t_list, model, [template_from_arrays(
        template_to_arrays(jtpl)), bins], device=CPU)
    _, x = _ball(jc.fitters[0], jmodel)
    want = np.asarray(jax.vmap(jc.lnposterior)(jnp.asarray(x)))
    with torch.no_grad():
        got = torch.func.vmap(c.lnposterior)(torch.tensor(x)).numpy()
    lims = np.array([sum(_limit(f, xi) for f in c.fitters) for xi in x])
    assert np.all(np.abs(got - want) <= lims)


@pytest.mark.parametrize("kind", ["analytic", "template"])
def test_chain_matches_jax(photons, kind):
    jf, f = _fitters(photons, kind)
    tpl = case.true_template().params if kind == "template" else None
    s, x0 = _ball(jf, jf.model, NW, tpl)
    s.run_mcmc(jnp.asarray(x0), NS)
    jchain, jlnp = np.asarray(s.chain), np.asarray(s.lnprob)
    path = np.concatenate([x0[None], jchain])
    jacc = np.any(path[1:] != path[:-1], axis=-1)
    draws = replay_draws(sampler_keys(0)[1], NS, NW // 2)
    with torch.no_grad():
        out = run_chain(f.lnposterior, x0, NS, device=CPU, draws=draws)
    limit = _limit(f, x0[0])
    margin, _, _ = decision_margins(out, draws)
    upto = tol.photon_parting_step(margin, out["accepted"], jacc, limit)
    assert upto > 0
    assert np.array_equal(out["chain"][:upto], jchain[:upto])
    assert np.array_equal(out["accepted"][:upto], jacc[:upto])
    assert tol.photon_lnp_ok(out["lnp"][:upto], jlnp[:upto], limit)


@pytest.mark.parametrize("walkers", [8, 2])
def test_one_plain_k12_per_vmapped_call(photons, monkeypatch, walkers):
    _, f = _fitters(photons, "template")
    calls = []
    inner = tt.photon_lnlike_plain

    def spy(*a, **k):
        calls.append(a[0].shape)
        return inner(*a, **k)

    monkeypatch.setattr(tt, "photon_lnlike_plain", spy)
    center = np.array([f.model.values[n] for n in f.param_names]
                      + list(f.template.params))
    x = torch.tensor(np.tile(center, (walkers, 1)))
    with torch.no_grad():
        torch.func.vmap(f.lnposterior)(x)
    assert len(calls) == 1  # one call for the batch, not one per walker


def test_fit_toas_writes_values_and_spread(photons):
    _, f = _fitters(photons, "analytic")
    start = dict(f.model.values)
    lnp = f.fit_toas(nwalkers=8, nsteps=6, seed=1)
    assert np.isfinite(lnp)
    best, blnp = f.sampler.max_posterior()
    assert blnp == lnp
    for i, n in enumerate(f.param_names):
        assert f.model.values[n] == float(best[i])
        assert f.model.uncertainties[n] == float(
            f.sampler.flatchain(burn=1)[:, i].std())
    assert any(f.model.values[n] != start[n] for n in f.param_names)


def test_entry_points_default_to_cuda(photons, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = get_model(photons["par"])
    tpl = template_from_arrays(template_to_arrays(case.true_template()))
    calls = [
        functools.partial(MCMCFitter, photons["toas"], model, tpl),
        functools.partial(tt.LCFitter, tpl, np.zeros(4)),
        functools.partial(tpl.density, np.zeros(4)),
        functools.partial(tpl.lnlike_fn, np.zeros(4)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
