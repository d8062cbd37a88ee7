"""Host ingest and model build of the port against pint_tpu, on the CPU.

The same inputs, made from a seed with numpy, go through both packages:

- time scales and MJD strings -> ticks: exact;
- observatory geometry and clock chains (``gbt``, ``@``, ``coe``):
  bit-identical on one host (the same numpy arithmetic in the same
  order; across hosts the limit is PERF.md's ingest row);
- ``read_tim`` of a tim ``pint_tpu.toa.write_tim`` wrote, and the
  prepared ``TOAs``: ticks exact, table equal;
- ``get_model`` on the B1855-like par: components, values, epochs and
  free parameters equal; unported components raise;
- ``make_fake_toas_uniform`` under one seed: the same TOAs;
- the committed tim against the JAX table stored beside it;
- a subprocess that fits from par and tim without JAX.
"""

import copy
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import B1855_LIKE_PAR
from pint_tpu.models.builder import get_model as jget_model
from pint_tpu.models.builder import get_model_and_toas as jget_mt
from pint_tpu.obs import get_observatory as jobs
from pint_tpu.residuals import Residuals as JResiduals
from pint_tpu.simulation import make_fake_toas_uniform as jfake
from pint_tpu.time import mjd as jmjd
from pint_tpu.time import scales as jscales
from pint_tpu.toa import read_tim as jread_tim
from pint_tpu.toa import write_tim
from pint_tpu_torch.convert import (B1855_PAR, B1855_TIM, B1855_TIM_ANSWERS,
                                    load_arrays)
from pint_tpu_torch.models.builder import get_model
from pint_tpu_torch.models.builder import get_model_and_toas
from pint_tpu_torch.obs import get_observatory
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.simulation import make_fake_toas_uniform
from pint_tpu_torch.time import mjd, scales
from pint_tpu_torch.toa import TOAs, read_tim
from tools.export_torch_case import _table_arrays

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
RECEIVERS = ((np.linspace(1150.0, 1750.0, 5), "L-wide", 1.0),
             (np.linspace(1900.0, 2700.0, 5), "S-wide", 1.5))


def _mjd_strings(seed, n=200):
    rng = np.random.default_rng(seed)
    days = rng.integers(45000, 60000, n)
    fracs = rng.integers(0, 10**16, n)
    return [f"{d}.{f:016d}" for d, f in zip(days, fracs)]


def _two_band(model, fake, seed=0, device=None):
    """A seeded 400-TOA two-band set: 40 epochs per receiver, five
    sub-bands each."""
    kw = {} if device is None else {"device": device}
    rng = np.random.default_rng(seed)
    return [fake(53000.0 + 0.01 * i, 56500.0 + 0.01 * i, 40, model,
                 freq_mhz=freqs, obs="gbt", error_us=err, add_noise=True,
                 rng=rng, flags={"f": flag}, multifreq=True, **kw)
            for i, (freqs, flag, err) in enumerate(RECEIVERS)]


@pytest.fixture(scope="module")
def par_tim(tmp_path_factory):
    """A 400-TOA par/tim pair written by pint_tpu."""
    from pint_tpu.toa import TOAs as JTOAs

    d = tmp_path_factory.mktemp("partim")
    par, tim = d / "b1855.par", d / "b1855.tim"
    par.write_text(B1855_LIKE_PAR)
    write_tim(JTOAs.merge(_two_band(jget_model(B1855_LIKE_PAR), jfake)),
              str(tim), include_info=False)
    return str(par), str(tim)


# --------------------------------------------------------------------------
# time scales
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_mjd_strings_to_ticks_exact(seed):
    for s in _mjd_strings(seed):
        dfj = jmjd.mjd_string_to_day_frac(s)
        assert mjd.mjd_string_to_day_frac(s) == dfj
        assert mjd.mjd_to_ticks_tdb(*dfj) == jmjd.mjd_to_ticks_tdb(*dfj)
        assert mjd.mjd_to_ticks_utc(*dfj, clock_offset_sec=1.5e-6) == \
            jmjd.mjd_to_ticks_utc(*dfj, clock_offset_sec=1.5e-6)
    for s in ("53478.2858714192189", "-1.5D2", "54000", "5.4E4"):
        assert mjd.mjd_string_to_day_frac(s) == \
            jmjd.mjd_string_to_day_frac(s)


def test_ticks_back_to_strings_exact():
    rng = np.random.default_rng(3)
    ticks = rng.integers(-2**61, 2**61, 100)
    for t in ticks:
        assert mjd.ticks_to_mjd_string_tdb(int(t)) == \
            jmjd.ticks_to_mjd_string_tdb(int(t))
    d, f = mjd.ticks_to_mjd_tdb(ticks)
    dj, fj = jmjd.ticks_to_mjd_tdb(ticks)
    assert np.array_equal(d, dj) and np.array_equal(f, fj)
    mjds = np.random.default_rng(4).uniform(40000.0, 70000.0, 100)
    assert np.array_equal(mjd.mjd_float_to_ticks_tdb(mjds),
                          jmjd.mjd_float_to_ticks_tdb(mjds))


def test_time_scales_exact():
    days = np.random.default_rng(5).integers(41317, 62000, 500)
    assert np.array_equal(scales.tai_minus_utc(days),
                          jscales.tai_minus_utc(days))
    tt = np.random.default_rng(6).uniform(-9e8, 9e8, 500)
    assert np.array_equal(scales.tdb_minus_tt_seconds(tt),
                          jscales.tdb_minus_tt_seconds(tt))
    assert scales.tdb_minus_tt_seconds(1.5e8) == \
        jscales.tdb_minus_tt_seconds(1.5e8)
    with pytest.raises(ValueError):
        scales.tai_minus_utc(40000)


# --------------------------------------------------------------------------
# observatories, clocks, ephemeris
# --------------------------------------------------------------------------

@pytest.mark.parametrize("site", ["gbt", "@", "coe"])
def test_observatory_geometry_and_clock_chain(site):
    o, oj = get_observatory(site), jobs(site)
    assert (o.name, o.is_barycenter, type(o).__name__) == \
        (oj.name, oj.is_barycenter, type(oj).__name__)
    ticks = np.sort(np.random.default_rng(7).integers(
        -4 * 10**8 * 2**32, 6 * 10**8 * 2**32, 300))
    pv, pvj = o.posvel_ssb(ticks), oj.posvel_ssb(ticks)
    assert np.array_equal(pv.pos, pvj.pos)
    assert np.array_equal(pv.vel, pvj.vel)
    mjds = np.random.default_rng(8).uniform(50000.0, 60000.0, 300)
    assert np.array_equal(o.clock_corrections_sec(mjds),
                          oj.clock_corrections_sec(mjds))


def test_clock_chain_files_match():
    from pint_tpu.obs.clock import find_clock_chain as jchain
    from pint_tpu_torch.obs.clock import find_clock_chain

    for site in ("gbt", "arecibo", "parkes"):
        a, b = find_clock_chain(get_observatory(site)), jchain(jobs(site))
        assert [c.name for c in a] == [c.name for c in b]
        for ca, cb in zip(a, b):
            assert np.array_equal(ca.mjds, cb.mjds)
            assert np.array_equal(ca.offsets, cb.offsets)


def test_spk_kernel_not_ported(tmp_path):
    from pint_tpu_torch.ephem import get_ephemeris

    kernel = tmp_path / "de440.bsp"
    kernel.write_bytes(b"")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_ephemeris(str(kernel))


# --------------------------------------------------------------------------
# tim files and TOAs
# --------------------------------------------------------------------------

def test_read_tim_matches(par_tim):
    _, tim = par_tim
    a, b = read_tim(tim), jread_tim(tim)
    assert len(a) == len(b) == 400
    for x, y in zip(a, b):
        assert (x.mjd_day, x.frac_num, x.frac_den, x.error_us, x.freq_mhz,
                x.obs, x.flags, x.name) == \
            (y.mjd_day, y.frac_num, y.frac_den, y.error_us, y.freq_mhz,
             y.obs, y.flags, y.name)


def test_read_tim_commands(tmp_path):
    """TIME, EFAC, EQUAD, SKIP, PHASE and INCLUDE act as in pint_tpu."""
    sub = tmp_path / "sub.tim"
    sub.write_text("FORMAT 1\nx 1400.0 54001.5 1.0 gbt -f L\n")
    tim = tmp_path / "main.tim"
    tim.write_text(
        "FORMAT 1\nC a comment\nTIME 0.5\nEFAC 2\nEQUAD 3\n"
        "a 1400.0 54000.25 1.0 gbt -f L\nSKIP\n"
        "b 1400.0 54000.5 1.0 gbt\nNOSKIP\nPHASE 0.25\n"
        f"INCLUDE {sub.name}\nEND\nc 1400.0 54002.5 1.0 gbt\n")
    a, b = read_tim(str(tim)), jread_tim(str(tim))
    assert [(t.name, t.error_us, t.flags) for t in a] == \
        [(t.name, t.error_us, t.flags) for t in b]
    assert len(a) == 2


def test_toas_and_table_match(par_tim):
    from pint_tpu.toa import get_TOAs as jget_toas
    from pint_tpu_torch.toa import get_TOAs

    _, tim = par_tim
    t, tj = get_TOAs(tim), jget_toas(tim)
    assert np.array_equal(t.ticks, tj.ticks)
    for k in ("clock_sec", "mjd_float", "freq_mhz", "error_us",
              "ssb_obs_pos", "ssb_obs_vel", "obs_sun_pos"):
        assert np.array_equal(getattr(t, k), getattr(tj, k)), k
    assert t.obs_names == tj.obs_names and t.flags == tj.flags
    table = t.to_table()
    ref = _table_arrays("", tj)
    assert np.array_equal(table.ticks, ref["ticks"])
    assert sorted(table.flags) == list(ref["flag_keys"])
    for k, (names, index) in table.flags.items():
        assert np.array_equal(names, ref[f"flag_{k}_names"])
        assert np.array_equal(index, ref[f"flag_{k}_index"])
    merged = TOAs.merge([t, t])
    assert len(merged) == 800
    assert np.array_equal(merged.ticks[400:], t.ticks)


def test_fake_toas_same_under_seed():
    model, jmodel = get_model(B1855_LIKE_PAR), jget_model(B1855_LIKE_PAR)
    for a, b in zip(_two_band(model, make_fake_toas_uniform, seed=3,
                              device="cpu"),
                    _two_band(jmodel, jfake, seed=3)):
        assert np.array_equal(a.ticks, b.ticks)
        assert np.array_equal(a.ssb_obs_pos, b.ssb_obs_pos)
        assert a.flags == b.flags


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def test_get_model_matches():
    m, mj = get_model(B1855_LIKE_PAR), jget_model(B1855_LIKE_PAR)
    assert [type(c).__name__ for c in m.components] == \
        [type(c).__name__ for c in mj.components]
    assert m.free_params == list(mj.free_params)
    assert list(m.params) == list(mj.params)
    assert set(m.values) == set(mj.values)
    for k, v in mj.values.items():
        assert m.values[k] == v or (np.isnan(v) and np.isnan(m.values[k]))
    assert m.epoch_ticks == mj.epoch_ticks
    assert m.meta == mj.meta
    sto, stoj = m.component("ScaleToaError"), mj.component("ScaleToaError")
    assert sto.efac_selects == stoj.efac_selects
    assert m.component("EcorrNoise").selects == \
        mj.component("EcorrNoise").selects


@pytest.mark.parametrize("extra", [
    "BINARY ELL1\nPB 5.7 1\nA1 3.3 1\nTASC 53900.1 1\nEPS1 1e-5\n",
    "JUMP -f L-wide 1e-5 1\n",
    "DMX 14.0\nDMX_0001 1e-3 1\nDMXR1_0001 53000\nDMXR2_0001 53100\n",
    "PLANET_SHAPIRO Y\n",
    "FD1 1e-5 1\n",
    "TNDMAMP -13\nTNDMGAM 3\n",
])
def test_unported_components_raise(extra):
    base = B1855_LIKE_PAR.replace("BINARY DD\n", "").split("PB ")[0] \
        if extra.startswith("BINARY") else B1855_LIKE_PAR
    with pytest.raises(NotImplementedError, match="ROADMAP|not ported"):
        get_model(base + extra)


def test_tzr_table_matches(par_tim):
    from tools.export_torch_case import tzr_toas

    par, tim = par_tim
    model, toas = get_model_and_toas(par, tim)
    jmodel, jtoas = jget_mt(par, tim)
    tzr = model.component("AbsPhase").make_tzr_toas(model, toas)
    tzrj = tzr_toas(jmodel, jtoas)
    assert np.array_equal(tzr.ticks, tzrj.ticks)
    assert np.array_equal(tzr.ssb_obs_pos, tzrj.ssb_obs_pos)
    assert np.array_equal(tzr.freq_mhz, tzrj.freq_mhz)


def test_prefit_residuals_match(par_tim):
    par, tim = par_tim
    model, toas = get_model_and_toas(par, tim)
    jmodel, jtoas = jget_mt(par, tim)
    r = Residuals(toas, model, device="cpu").time_resids
    rj = np.asarray(JResiduals(jtoas, copy.deepcopy(jmodel)).time_resids)
    assert np.max(np.abs(r - rj)) <= 1e-11


def test_committed_tim_matches_stored_table():
    """The committed 10k tim through the port's ingest against the JAX
    table stored beside it: ticks and geometry exact on one host."""
    ref = load_arrays(B1855_TIM_ANSWERS)
    model, toas = get_model_and_toas(str(B1855_PAR), str(B1855_TIM))
    assert model.free_params == [str(p) for p in ref["free_params"]]
    t = toas.to_table()
    assert np.array_equal(t.ticks, ref["toa_ticks"])
    for k in ("freq_mhz", "error_us", "mjd_float", "ssb_obs_pos",
              "ssb_obs_vel", "obs_sun_pos"):
        assert np.array_equal(getattr(t, k), ref[f"toa_{k}"]), k
    for k, (names, index) in t.flags.items():
        assert np.array_equal(names, ref[f"toa_flag_{k}_names"])
        assert np.array_equal(index, ref[f"toa_flag_{k}_index"])


def test_fit_from_par_tim_without_jax(par_tim):
    par, tim = par_tim
    code = (
        "import sys\n"
        "from pint_tpu_torch.models.builder import get_model_and_toas\n"
        "from pint_tpu_torch.fitter import GLSFitter\n"
        f"m, t = get_model_and_toas({par!r}, {tim!r})\n"
        "chi2 = GLSFitter(t, m, device='cpu').fit_toas(maxiter=2)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'pint_tpu'))\n"
        "print(chi2, len(bad), bad[:5])\n"
        "sys.exit(1 if bad or not chi2 == chi2 else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
