"""Export the JAX CPU answers of two pulse-numbering cases, for the
port's chip check to be held to, and build the cases for the CPU tests.

- ``gap``: the gap case of tests/test_pulse_numbers.py -- the par
  :data:`PAR` with ``TRACK -2``, two clusters of 20 TOAs (MJD
  54000-54030 and 54330-54360, 1 us, site ``@``) from
  ``make_fake_toas_uniform``, here with their 1 us of white noise drawn
  from ``numpy.random.default_rng(GAP_NOISE_SEED)`` (without it the
  postfit chi^2 is ~1e-7, rounding, and its relative agreement says
  nothing); pulse numbers assigned by
  ``compute_pulse_numbers`` at the par's F0, then a ``WLSFitter`` fit
  (maxiter=3) from F0 + 1e-7 Hz, 2.6 turns of drift across the gap;
- ``phase``: corpus scenario spin-000 (``pint_tpu.corpus.spec``, 30
  TOAs, F0 483.7 Hz) with ``PHASE 0.3`` before its 13th TOA, fitted by
  ``WLSFitter`` (maxiter=3) from its par: nearest tracking after the
  PHASE offset.

Written arrays, per case ``<k>``: ``<k>_par`` and ``<k>_tim`` (the
files' text; the gap tim carries no ``-pn`` flag, the port assigns
them), ``<k>_start`` (the F0 the fit starts from), ``<k>_pn`` (JAX's
pulse numbers, int64; gap only), ``<k>_prefit`` and ``<k>_postfit``
(time residuals [s] at the start and after the fit), ``<k>_free``,
``<k>_values``, ``<k>_sigmas``, ``<k>_chi2_iters`` and ``<k>_chi2``;
and the commit.

Usage (from the repo root, ~15 s)::

    JAX_PLATFORMS=cpu python tools/export_torch_pn_case.py
"""

from __future__ import annotations

import argparse
import copy
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pint_tpu_torch", "data", "pn_answers.npz")

#: the par of tests/test_pulse_numbers.py
PAR = """PSR  J0000+0000
RAJ 05:00:00.0
DECJ 15:00:00.0
F0 100.0 1
F1 0.0
PEPOCH 54100
DM 10.0
TZRMJD 54100
TZRSITE @
TZRFRQ 1400
EPHEM builtin
UNITS TDB
"""
#: the F0 error the gap fit starts from [Hz]
GAP_DF0 = 1e-7
#: the seed of the exported gap case's white noise
GAP_NOISE_SEED = 11
#: the PHASE command of the phase case [turns], and the TOA it precedes
PHASE_TURNS = 0.3
PHASE_AT = 12


def write_gap_tim(model, path, rng=None):
    """The gap case's 40 TOAs under ``model`` (a pint_tpu model), written
    by pint_tpu's ``write_tim``; with white noise of their 1 us errors
    drawn from ``rng`` when one is given."""
    from pint_tpu.simulation import make_fake_toas_uniform
    from pint_tpu.toa import TOAs, write_tim

    a, b = (make_fake_toas_uniform(lo, lo + 30, 20, model, obs="@",
                                   error_us=1.0, add_noise=rng is not None,
                                   rng=rng) for lo in (54000, 54330))
    write_tim(TOAs.merge([a, b]), path)
    return path


def write_spin_case(outdir):
    """(par path, tim path) of corpus scenario spin-000 under
    ``outdir``."""
    from pint_tpu.corpus.spec import build_class

    return build_class("spin", count=1)[0].write(outdir)


def _toa_lines(lines):
    return [i for i, ln in enumerate(lines)
            if ln.strip() and not ln.startswith(("FORMAT", "C ", "MODE"))]


def insert_phase(tim_in, tim_out, turns=PHASE_TURNS, at=PHASE_AT):
    """``tim_in`` with ``PHASE turns`` before its TOA number ``at``."""
    lines = open(tim_in).read().splitlines()
    lines.insert(_toa_lines(lines)[at], f"PHASE {turns!r}")
    with open(tim_out, "w") as f:
        f.write("\n".join(lines) + "\n")
    return tim_out


def write_pn_tim(par, tim_in, tim_out, every=5):
    """``tim_in`` with a ``-pn`` flag on every TOA, pint_tpu's
    ``compute_pulse_numbers`` under ``par``, and every ``every``-th TOA
    (from the first) one turn ahead."""
    from pint_tpu.models.builder import get_model
    from pint_tpu.toa import get_TOAs, write_tim

    toas = get_TOAs(tim_in, ephem="builtin")
    pn = toas.compute_pulse_numbers(get_model(par))
    for i in range(0, len(pn), every):
        toas.flags[i]["pn"] = repr(int(pn[i]) + 1)
    write_tim(toas, tim_out)
    return tim_out


def _fit(par, tim, df0=0.0, assign_pn=False):
    """JAX's answers of one case: {pn, start, prefit, postfit, free,
    values, sigmas, chi2_iters, chi2}."""
    from pint_tpu.fitter import WLSFitter
    from pint_tpu.models.builder import get_model
    from pint_tpu.residuals import Residuals
    from pint_tpu.toa import get_TOAs

    model = get_model(par)
    toas = get_TOAs(tim, ephem="builtin")
    out = {}
    if assign_pn:
        out["pn"] = np.asarray(toas.compute_pulse_numbers(model), np.int64)
    start = copy.deepcopy(model)
    start["F0"] = model.values["F0"] + df0
    out["start"] = np.float64(start.values["F0"])
    out["prefit"] = Residuals(toas, start).time_resids
    os.environ["PINT_TPU_ITER_TRACE"] = "1"
    try:
        f = WLSFitter(toas, start)
        out["chi2"] = np.float64(f.fit_toas(maxiter=3))
    finally:
        os.environ.pop("PINT_TPU_ITER_TRACE", None)
    out["postfit"] = f.resids.time_resids
    free = list(f.model.free_params)
    out["free"] = np.asarray(free, dtype=np.str_)
    out["values"] = np.array([f.model.values[k] for k in free])
    out["sigmas"] = np.array([f.model.params[k].uncertainty for k in free])
    out["chi2_iters"] = np.array([e["chi2"] for e in f.iter_trace])
    return out


def build(outdir):
    """{array name: value} of both cases, their files under
    ``outdir``."""
    from pint_tpu.models.builder import get_model

    gap_par = os.path.join(outdir, "gap.par")
    with open(gap_par, "w") as f:
        f.write(PAR + "TRACK -2\n")
    gap_tim = write_gap_tim(get_model(gap_par),
                            os.path.join(outdir, "gap.tim"),
                            rng=np.random.default_rng(GAP_NOISE_SEED))
    spin_par, spin_tim = write_spin_case(outdir)
    phase_tim = insert_phase(spin_tim, os.path.join(outdir, "phase.tim"))
    out = {}
    for k, par, tim, df0, pn in (("gap", gap_par, gap_tim, GAP_DF0, True),
                                 ("phase", spin_par, phase_tim, 0.0,
                                  False)):
        for name, v in _fit(par, tim, df0, pn).items():
            out[f"{k}_{name}"] = v
        out[f"{k}_par"] = np.asarray(open(par).read())
        out[f"{k}_tim"] = np.asarray(open(tim).read())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        out = build(d)
    out["commit"] = np.asarray(subprocess.run(
        ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__))).stdout.strip())
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: " + ", ".join(sorted(out)))


if __name__ == "__main__":
    main()
