"""Pulse-number tracking and PHASE commands, the port against pint_tpu
on the CPU: the twin of tests/test_pulse_numbers.py.

Across a 300-day gap an F0 error of 1e-7 Hz accumulates 2.6 turns:
nearest-integer tracking wraps it into half a turn, tracking by the
``-pn`` pulse numbers exposes it and lets a fit recover F0.  The same
tim files (written by pint_tpu) go through both packages: pulse numbers
assigned by ``compute_pulse_numbers``, the track mode resolved from an
explicit argument, the par's TRACK or complete ``-pn`` flags (with the
same refusals), PHASE-command offsets before the nearest-integer
assignment, and the paths that carry them (WLS, GLS, a grid, a streamed
append).  Residuals are held within ``tolerances.PREFIT_S`` (1e-11 s),
fits by ``tolerances.fit_tolerances``.  The write_tim round trip of
``-pn`` flags waits for ROADMAP queue 1 item 1 (the port has no
write_tim).
"""

import copy

import numpy as np
import pytest
import torch

from pint_tpu import grid as jgrid
from pint_tpu.fitter import GLSFitter as JGLSFitter
from pint_tpu.fitter import WLSFitter as JWLSFitter
from pint_tpu.models.builder import get_model as jget_model
from pint_tpu.residuals import Residuals as JResiduals
from pint_tpu.simulation import make_fake_toas_uniform as jfake
from pint_tpu.toa import get_TOAs as jget_TOAs
from pint_tpu.toa import write_tim
from pint_tpu_torch import grid as tgrid
from pint_tpu_torch import tolerances as tol
from pint_tpu_torch.fitter import GLSFitter, WLSFitter
from pint_tpu_torch.models.builder import get_model
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.toa import get_TOAs
from tools.export_torch_pn_case import (GAP_DF0, PAR, PHASE_AT,
                                        PHASE_TURNS, insert_phase,
                                        write_gap_tim, write_pn_tim,
                                        write_spin_case)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Paths of the pars (plain, TRACK -2, TRACK 0), the gap tim, corpus
    spin-000's par and tim, the latter with PHASE 0.3 and with -pn flags
    (every fifth TOA a turn ahead)."""
    d = tmp_path_factory.mktemp("pn")
    out = {}
    for name, extra in (("par", ""), ("t2", "TRACK -2\n"),
                        ("t0", "TRACK 0\n")):
        out[name] = str(d / f"{name}.par")
        with open(out[name], "w") as f:
            f.write(PAR + extra)
    out["gap"] = write_gap_tim(jget_model(out["par"]), str(d / "gap.tim"))
    out["spin_par"], out["spin_tim"] = write_spin_case(str(d))
    out["phase_tim"] = insert_phase(out["spin_tim"], str(d / "phase.tim"))
    out["pn_tim"] = write_pn_tim(out["spin_par"], out["spin_tim"],
                                 str(d / "pn.tim"))
    return out


def _both(par, tim, assign=True):
    """(JAX model, JAX TOAs, port model, port TOAs), pulse numbers
    assigned by each package's compute_pulse_numbers when ``assign``."""
    jmodel, jtoas = jget_model(par), jget_TOAs(tim, ephem="builtin")
    model, toas = get_model(par), get_TOAs(tim)
    if assign:
        jtoas.compute_pulse_numbers(jmodel)
        toas.compute_pulse_numbers(model, device=CPU)
    return jmodel, jtoas, model, toas


def _resid_diff(jr, r):
    """max |port - JAX| of the time residuals [s]."""
    return float(np.max(np.abs(r.time_resids - jr.time_resids)))


# -- compute and carry --------------------------------------------------------

def test_compute_assigns_pn_flags(files):
    jmodel, jtoas, model, toas = _both(files["par"], files["gap"],
                                       assign=False)
    jpn = jtoas.compute_pulse_numbers(jmodel)
    pn = toas.compute_pulse_numbers(model, device=CPU)
    assert pn.dtype == np.int64 and np.array_equal(pn, jpn)
    got = toas.get_pulse_numbers()
    assert got is not None and np.array_equal(got.astype(np.int64), pn)
    assert np.array_equal(toas.to_table().get_pulse_numbers(), got)
    r = Residuals(toas, model, device=CPU, track_mode="use_pulse_numbers")
    jr = JResiduals(jtoas, jmodel, track_mode="use_pulse_numbers")
    assert np.max(np.abs(r.phase_resids)) < 1e-6
    assert _resid_diff(jr, r) <= tol.PREFIT_S
    assert r._pn.dtype == torch.int64 and r._dpn is None


@pytest.mark.parametrize("mode", ["nearest", "use_pulse_numbers"])
def test_gap_misassignment_vs_tracking(files, mode):
    """F0 + 1e-7 Hz: nearest wraps the 2.6-turn drift into half a turn,
    pulse numbers expose it as the predicted linear drift; both modes
    equal JAX's residuals."""
    jmodel, jtoas, model, toas = _both(files["par"], files["gap"])
    jr = JResiduals(jtoas, jmodel, subtract_mean=False, track_mode=mode)
    r = Residuals(toas, model, device=CPU, subtract_mean=False,
                  track_mode=mode)
    jvals = dict(jmodel.values)
    jvals["F0"] = jvals["F0"] + GAP_DF0
    jph = np.asarray(jr._phase_resids_jit(jr._values(jvals), jr._data()))
    vals = dict(model.values)
    vals["F0"] = vals["F0"] + GAP_DF0
    ph = r.phase_resids_at(r.prepared.values_dict(vals)).numpy()
    assert np.max(np.abs(ph - jph)) / vals["F0"] <= tol.PREFIT_S
    if mode == "nearest":
        assert np.max(np.abs(ph)) <= 0.5
    else:
        assert np.max(np.abs(ph)) > 2.0
        t_sec = toas.ticks / 2**32
        pred = GAP_DF0 * (t_sec - (54100.0 - 51544.5) * 86400.0)
        assert np.max(np.abs(ph - pred)) < 1e-3


def _fit_limits(tf, kind):
    cond = tf.fit_health["cond_log10"]
    if kind == "wls":
        cond = tol.wls_normal_cond_log10(cond)
    return tol.fit_tolerances(cond)


def _value_errors(jf, tf):
    """{values_sigma, unc_rel} of the port's fit against JAX's."""
    free = list(jf.model.free_params)
    assert list(tf.model.free_params) == free
    v = np.array([tf.model.values[k] for k in free])
    u = np.array([tf.model.uncertainties[k] for k in free])
    jv = np.array([jf.model.values[k] for k in free])
    ju = np.array([jf.model.params[k].uncertainty for k in free])
    return {"values_sigma": float(np.max(np.abs(v - jv) / ju)),
            "unc_rel": float(np.max(np.abs(u / ju - 1.0)))}


def _check_fit(jf, tf, kind):
    lim = _fit_limits(tf, kind)
    for k, v in _value_errors(jf, tf).items():
        assert v <= lim[k], (k, v, lim[k])
    assert _resid_diff(jf.resids, tf.resids) <= tol.PREFIT_S


@pytest.mark.parametrize("kind", ["wls", "gls"])
def test_fit_recovers_f0_across_gap(files, kind):
    """From F0 + 1e-7 Hz the fit under pulse numbers (selected by the
    complete -pn flags) recovers F0, as JAX's does."""
    jcls, tcls = {"wls": (JWLSFitter, WLSFitter),
                  "gls": (JGLSFitter, GLSFitter)}[kind]
    jmodel, jtoas, model, toas = _both(files["par"], files["gap"])
    jstart = copy.deepcopy(jmodel)
    jstart["F0"] = jmodel.values["F0"] + GAP_DF0
    start = copy.deepcopy(model)
    start.values["F0"] = model.values["F0"] + GAP_DF0
    jf = jcls(jtoas, jstart)
    jchi2 = jf.fit_toas(maxiter=3)
    tf = tcls(toas, start, device=CPU)
    assert tf.resids.track_mode == jf.resids.track_mode \
        == "use_pulse_numbers"
    chi2 = tf.fit_toas(maxiter=3)
    assert abs(tf.model.values["F0"] - 100.0) < 1e-11
    _check_fit(jf, tf, kind)
    assert abs(chi2 / jchi2 - 1.0) <= _fit_limits(tf, kind)["chi2_rel"]


def test_grid_carries_pulse_numbers(files):
    """A 2 x 2 (F1, DM) grid refitting F0 under pulse numbers, against
    JAX's: the pulse numbers are data shared by every point."""
    jmodel, jtoas, model, toas = _both(files["par"], files["gap"])
    pts = np.array([[0.0, 10.0], [0.0, 10.001], [1e-17, 10.0],
                    [1e-17, 10.001]])
    jchi2, jfit = jgrid.grid_chisq_vectorized(jtoas, jmodel, ["F1", "DM"],
                                              pts)
    fn, fit_params, _ = tgrid.make_grid_fn(toas, model, ["F1", "DM"],
                                           device=CPU)
    chi2, fitted = (x.numpy() for x in fn(pts))
    assert fit_params == ["F0"]
    f = WLSFitter(toas, copy.deepcopy(model), device=CPU)
    f.fit_toas(maxiter=3)
    lim = _fit_limits(f, "wls")
    assert np.max(np.abs(chi2 / np.asarray(jchi2) - 1)) \
        <= tol.REFIT_CHI2_REL
    assert tol.values_sigma_ulp(fitted, jfit, [
        f.model.uncertainties["F0"]]) <= lim["values_sigma"]
    # F1 = 1e-17 drifts 0.5 F1 t^2 ~ 3 turns across the gap: the
    # tracked chi^2 sees it
    assert chi2[2] > 1e3 * chi2[0]


def test_streamed_append_carries_pulse_numbers(files):
    """A bucketed WLS fit of the first cluster under pulse numbers (the
    pad rows copy the last TOA's -pn flag), then the second cluster
    appended by append_refit, incrementally (the mini dataset and the
    merged residuals carry the track mode): the same mode, chi^2 and
    values as JAX's stream."""
    jmodel, jtoas, model, toas = _both(files["par"], files["gap"])
    first, second = np.arange(20), np.arange(20, 40)
    jf = JWLSFitter(jtoas[first], copy.deepcopy(jmodel), bucket=True)
    tf = WLSFitter(toas[first], copy.deepcopy(model), device=CPU,
                   bucket=True)
    assert tf.resids.track_mode == "use_pulse_numbers"
    jf.fit_toas(maxiter=3)
    tf.fit_toas(maxiter=3)
    jinfo = jf.append_refit(jtoas[second], maxiter=3)
    info = tf.append_refit(toas[second], maxiter=3)
    assert info["mode"] == jinfo["mode"] == "incremental"
    assert tf.resids.track_mode == "use_pulse_numbers"
    assert abs(float(info["chi2"]) / float(jinfo["chi2"]) - 1.0) \
        <= tol.stream_chi2_limit()
    assert _value_errors(jf, tf)["values_sigma"] \
        <= _fit_limits(tf, "wls")["values_sigma"]
    # a night without -pn flags is refused under pulse numbers, not
    # tracked to the nearest pulse
    with pytest.raises(ValueError, match="pulse numbers"):
        jf.append_refit(jget_TOAs(files["gap"], ephem="builtin")[second])
    with pytest.raises(ValueError, match="pulse numbers"):
        tf.append_refit(get_TOAs(files["gap"])[second])


# -- track-mode selection -------------------------------------------------------

def test_track_minus2_selects_pulse_numbers(files):
    _, _, _, toas = _both(files["par"], files["gap"])
    r = Residuals(toas, get_model(files["t2"]), device=CPU)
    assert r.track_mode == "use_pulse_numbers"


def test_track_minus2_without_pn_raises(files):
    """TRACK -2 without -pn flags raises in both packages."""
    jm = jget_model(files["t2"])
    jtoas = jfake(54000, 54010, 5, jm, obs="@")
    with pytest.raises(ValueError, match="pulse numbers"):
        JResiduals(jtoas, jm, track_mode=None)
    toas = get_TOAs(files["gap"])
    with pytest.raises(ValueError, match="pulse numbers"):
        Residuals(toas, get_model(files["t2"]), device=CPU)


def test_complete_pn_flags_auto_select(files):
    _, _, model, toas = _both(files["par"], files["gap"])
    assert Residuals(toas, model, device=CPU).track_mode \
        == "use_pulse_numbers"
    # without the flags: nearest
    assert Residuals(get_TOAs(files["gap"]), model,
                     device=CPU).track_mode == "nearest"


def test_track_zero_forces_nearest(files):
    _, _, _, toas = _both(files["par"], files["gap"])
    r = Residuals(toas, get_model(files["t0"]), device=CPU)
    assert r.track_mode == "nearest"


def test_track_mode_refusals(files):
    """An unknown mode, and pulse-number tracking with some TOAs
    unnumbered, raise as JAX's do; "pulse_number" is accepted."""
    jmodel, jtoas, model, toas = _both(files["par"], files["gap"])
    for pkg, t, m in (("jax", jtoas, jmodel), ("torch", toas, model)):
        make = (lambda **k: JResiduals(t, m, **k)) if pkg == "jax" \
            else (lambda **k: Residuals(t, m, device=CPU, **k))
        with pytest.raises(ValueError, match="unknown track_mode"):
            make(track_mode="closest")
        assert make(track_mode="pulse_number").track_mode \
            == "use_pulse_numbers"
        del t.flags[3]["pn"]
        with pytest.raises(ValueError, match="missing"):
            make(track_mode="use_pulse_numbers")
        assert make().track_mode == "nearest"


# -- PHASE commands ------------------------------------------------------------

def test_phase_command_delta(files, tmp_path):
    jm = jget_model(files["par"])
    toas0 = jfake(54000, 54010, 6, jm, obs="@", error_us=1.0)
    path = str(tmp_path / "ph.tim")
    write_tim(toas0, path)
    p2 = insert_phase(path, str(tmp_path / "ph2.tim"), turns=0.25, at=3)
    jtoas = jget_TOAs(p2, ephem="builtin")
    toas = get_TOAs(p2)
    dpn = toas.get_delta_pulse_numbers()
    assert np.array_equal(dpn, jtoas.get_delta_pulse_numbers())
    assert np.allclose(dpn[:3], 0.0) and np.allclose(dpn[3:], 0.25)
    assert np.array_equal(toas.to_table().get_delta_pulse_numbers(), dpn)
    r = Residuals(toas, get_model(files["par"]), device=CPU,
                  subtract_mean=False, track_mode="nearest")
    jr = JResiduals(jtoas, jm, subtract_mean=False, track_mode="nearest")
    resid = r.phase_resids
    assert np.allclose(resid[:3], 0.0, atol=1e-6)
    assert np.allclose(resid[3:], 0.25, atol=1e-6)
    assert _resid_diff(jr, r) <= tol.PREFIT_S


# -- corpus spin-000 -------------------------------------------------------------

def test_spin_phase_command(files):
    """spin-000 with PHASE 0.3 before its 13th TOA: JAX's residuals move
    to ~300 us rms; the port's equal them, and the WLS fit holds."""
    jmodel, jtoas, model, toas = _both(files["spin_par"],
                                       files["phase_tim"], assign=False)
    dpn = toas.get_delta_pulse_numbers()
    assert np.count_nonzero(dpn == PHASE_TURNS) == len(toas) - PHASE_AT
    jr, r = JResiduals(jtoas, jmodel), Residuals(toas, model, device=CPU)
    assert r.track_mode == "nearest" and r._dpn is not None
    assert np.std(jr.time_resids) > 1e-4
    assert _resid_diff(jr, r) <= tol.PREFIT_S
    jf = JWLSFitter(jtoas, jmodel)
    jf.fit_toas(maxiter=3)
    tf = WLSFitter(toas, model, device=CPU)
    tf.fit_toas(maxiter=3)
    _check_fit(jf, tf, "wls")


def test_spin_pn_flags_one_turn_ahead(files):
    """spin-000 with -pn on every TOA, every fifth a turn ahead: both
    packages track by the flags and their residuals agree."""
    jmodel, jtoas, model, toas = _both(files["spin_par"], files["pn_tim"],
                                       assign=False)
    jr, r = JResiduals(jtoas, jmodel), Residuals(toas, model, device=CPU)
    assert r.track_mode == jr.track_mode == "use_pulse_numbers"
    assert np.max(np.abs(jr.time_resids)) > 1e-3
    assert _resid_diff(jr, r) <= tol.PREFIT_S
