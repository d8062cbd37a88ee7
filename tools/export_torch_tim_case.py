"""Export two cases for the port, each with the JAX CPU answers beside
it.

**The par/tim case** (``--tim-out``): the B1855-like DD par
(``bench.B1855_LIKE_PAR``) written beside the tim as ``b1855_like.par``,
and the TOAs of the 10k epoch case (``tools/export_torch_case.
epoch_toas(model, 200, 25, seed=0)``: 400 ECORR epochs of 25 sub-band
TOAs, GBT, two receivers) written by ``pint_tpu.toa.write_tim`` to the
tim path.  Beside them ``<tim stem>_answers.npz`` holds what JAX makes
of the pair through ``get_model_and_toas(par, tim)``:

- the TOA and TZR tables (``toa_*``, ``tzr_*``: ticks, frequencies,
  errors, MJDs, the three geometry arrays, the flags) and the prefit
  time residuals;
- ``GLSFitter.fit_toas(maxiter=3)`` and ``WLSFitter.fit_toas(
  maxiter=3)`` (``gls_*``, ``wls_*``): the fitted values and their
  uncertainties in fit order, the chi^2 of each iteration, the final
  chi^2, and the last step's ``n_truncated`` and ``cond_log10``.  The
  guard is on, as by default; a healthy fit at its baseline rung takes
  the same steps as with the guard off, which is how the port runs.

**The wide PTA case** (``--wide-out``): ``make_pta(4, 500)`` of
``tools/export_torch_pta_case.py`` with 100-mode intrinsic red noise on
every pulsar in place of 30, so each pulsar's capacity is ~203 columns
wide (200 Fourier columns, the mean and the timing design), past the
144 that one block of the port's narrow K5 holds.  The width comes from
red-noise modes and not from ECORR epochs because ECORR in a PTA case is
itself untested against JAX yet.  Beside the case arrays
(``pta_case_arrays``): ``lnlike`` at (-13.7, 13/3), ``lnlike_grid`` on
2 x 2 points, and the GWB posterior's (14 common modes, 10 dimensions)
lnprob and gradient at ``center()`` and three ``initial_chains`` rows.

Usage (from the repo root, ~1 min)::

    JAX_PLATFORMS=cpu python tools/export_torch_tim_case.py \\
        --tim-out pint_tpu_torch/data/b1855_epochs_10k.tim \\
        --wide-out pint_tpu_torch/data/pta4_wide.npz
"""

from __future__ import annotations

import argparse
import copy
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tools.export_torch_case import (_commit, _table_arrays,  # noqa: E402
                                     epoch_toas, tzr_toas)
from tools.export_torch_pta_case import (GWB_GAMMA, make_pta,  # noqa: E402
                                         pta_case_arrays)

WIDE_RED_PAR = "TNRedAmp -13.7\nTNRedGam 4.33\nTNRedC 100\n"
WIDE_GRID_LOG10_A = np.array([-14.5, -13.7])
WIDE_GRID_GAMMA = np.array([3.0, GWB_GAMMA])


def _fit(cls, model, toas, maxiter):
    m = copy.deepcopy(model)
    old = os.environ.get("PINT_TPU_ITER_TRACE")
    os.environ["PINT_TPU_ITER_TRACE"] = "1"
    try:
        f = cls(toas, m)
        final = f.fit_toas(maxiter=maxiter)
    finally:
        if old is None:
            os.environ.pop("PINT_TPU_ITER_TRACE", None)
        else:
            os.environ["PINT_TPU_ITER_TRACE"] = old
    free = list(m.free_params)
    return {
        "values": np.asarray([m.values[k] for k in free], np.float64),
        "uncertainties": np.asarray([m.params[k].uncertainty for k in free],
                                    np.float64),
        "chi2_iters": np.asarray([e["chi2"] for e in f.iter_trace],
                                 np.float64),
        "final_chi2": np.asarray(final, np.float64),
        "n_truncated": np.asarray(int(f.fit_health["n_truncated"])),
        "cond_log10": np.asarray(float(f.fit_health["cond_log10"])),
    }


def tim_case(tim, maxiter=3):
    """Write the par beside ``tim``, ``tim`` and the answers file."""
    from bench import B1855_LIKE_PAR
    from pint_tpu.fitter import GLSFitter, WLSFitter
    from pint_tpu.models.builder import get_model, get_model_and_toas
    from pint_tpu.residuals import Residuals
    from pint_tpu.toa import write_tim

    par = os.path.join(os.path.dirname(tim), "b1855_like.par")
    answers = os.path.splitext(tim)[0] + "_answers.npz"
    with open(par, "w") as f:
        f.write(B1855_LIKE_PAR)
    write_tim(epoch_toas(get_model(par), 200, 25, seed=0), tim,
              include_info=False)
    model, toas = get_model_and_toas(par, tim)
    out = {}
    out.update(_table_arrays("toa_", toas))
    out.update(_table_arrays("tzr_", tzr_toas(model, toas)))
    out["free_params"] = np.asarray(model.free_params, dtype=np.str_)
    out["prefit_time_resids"] = np.asarray(
        Residuals(toas, copy.deepcopy(model)).time_resids, np.float64)
    for name, cls in (("gls", GLSFitter), ("wls", WLSFitter)):
        for k, v in _fit(cls, model, toas, maxiter).items():
            out[f"{name}_{k}"] = v
    out["maxiter"] = np.asarray(maxiter)
    out["commit"] = np.asarray(_commit())
    np.savez_compressed(answers, **out)
    print(f"wrote {par}, {tim}, {answers}: {len(toas)} TOAs; GLS chi2 "
          f"{out['gls_chi2_iters'].tolist()}, WLS chi2 "
          f"{out['wls_chi2_iters'].tolist()}")


def wide_case(path):
    """Write the wide PTA case with its ``ref_*`` answers."""
    import jax
    import jax.numpy as jnp

    from pint_tpu.gw import CommonProcess, GWBPosterior

    pairs = make_pta(4, 500, extra_par=WIDE_RED_PAR)
    out = pta_case_arrays(pairs)
    crn = CommonProcess(pairs, nmodes=14, orf="hd", kron=True)
    out["ref_nmodes"] = np.asarray(14)
    out["ref_lnlike_point"] = np.asarray([-13.7, GWB_GAMMA])
    out["ref_lnlike"] = np.asarray(crn.lnlike(-13.7, GWB_GAMMA))
    out["ref_grid_log10_amp"] = WIDE_GRID_LOG10_A
    out["ref_grid_gamma"] = WIDE_GRID_GAMMA
    out["ref_grid_lnlike"] = np.asarray(
        crn.lnlike_grid(WIDE_GRID_LOG10_A, WIDE_GRID_GAMMA))
    post = GWBPosterior(crn)
    data = post.data()
    theta = np.concatenate([post.center()[None],
                            post.initial_chains(3, seed=1, ball=1.0)])
    vg = jax.jit(jax.vmap(jax.value_and_grad(
        lambda q: post.lnprob(q, data))))
    v, g = vg(jnp.asarray(theta))
    out["ref_param_names"] = np.asarray(post.param_names, dtype=np.str_)
    out["ref_theta"] = theta
    out["ref_lnprob"] = np.asarray(v)
    out["ref_grad"] = np.asarray(g)
    out["ref_commit"] = np.asarray(_commit())
    np.savez_compressed(path, **out)
    print(f"wrote {path}: 4 pulsars x 500 TOAs, 100 red-noise modes; "
          f"lnlike {float(out['ref_lnlike']):.6f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tim-out", required=True,
                    help="path of the tim file (par and answers beside it)")
    ap.add_argument("--wide-out", required=True)
    ap.add_argument("--maxiter", type=int, default=3)
    a = ap.parse_args(argv)
    tim_case(a.tim_out, maxiter=a.maxiter)
    wide_case(a.wide_out)


if __name__ == "__main__":
    main()
