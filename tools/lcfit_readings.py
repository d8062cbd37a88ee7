"""Print the readings behind ``tolerances.lcfit_limits`` on the template-fit
tests' inputs (3000 photons; the smooth template and the two-sided one of
``tests/test_torch_templates.py``), on the CPU:

- the port's disagreement with JAX's -lnL and gradient at the start, at
  JAX's fit and at 6 points around it, over sum_i |log x_i| and over each
  entry's S_k = sum_i |d log x_i / d theta_k|;
- JAX's fit under the perturbation of ``LCFIT_VALUE_REL`` /
  ``LCFIT_GRAD_REL``, one fit a seed: its largest movement in sigma and
  of lnL, the limit's fraction, and the port's fit against the nearest
  of JAX's fits and against JAX's own;
- with ``--wrong``, JAX's fits with one gradient entry wrong by
  ``LC_WRONG_REL`` S_k, one an entry, over the limit.

Usage (from the repo root, ~1 min)::

    JAX_PLATFORMS=cpu python tools/lcfit_readings.py [--wrong]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tests.test_torch_templates import (_lcfit_templates,  # noqa: E402
                                        _sample)
from tools import export_torch_photon_case as case  # noqa: E402

#: the tests' two templates: (Lorentzian, its true and start widths)
TEMPLATES = {"smooth": ("LCLorentzian", {"true": (0.05,),
                                         "start": (0.055,)}),
             "two-sided": ("LCLorentzian2", {"true": (0.05, 0.07),
                                             "start": (0.055, 0.065)})}


def readings(lorentzian, widths, wrong):
    import jax
    import jax.numpy as jnp

    import pint_tpu.templates as jt
    import pint_tpu_torch.templates as tt
    from pint_tpu_torch import tolerances as tol

    true, start = _lcfit_templates(lorentzian, **widths)
    phases, w = _sample(true, 3000, seed=5)
    jp, jl = case.lc_fit(start, phases, w)
    jf = jt.LCFitter(start(), phases, w)
    jf.template.params = np.array(jp)
    sigma = np.asarray(jf.param_uncertainties())
    lnx_abs, grad_abs = case.lc_sums(start(), phases, w, jp)
    scale = np.where(np.isfinite(sigma) & (sigma > 0), sigma, np.abs(jp))
    rng = np.random.default_rng(1)
    points = [np.array(start().params), jp] + [
        jp + 0.5 * scale * rng.standard_normal(len(jp)) for _ in range(6)]
    tf = tt.LCFitter(start(tt), phases, w, device="cpu")
    vg = jax.jit(jax.value_and_grad(lambda p: -jf._lnlike(p)))
    dv, dg = 0.0, np.zeros(len(jp))
    for p in points:
        jv, jg = vg(jnp.asarray(p))
        tv, tg = tf._val_grad(p)
        dv = max(dv, abs(float(tv) - float(jv)) / lnx_abs)
        dg = np.maximum(dg, np.abs(tg.numpy() - np.asarray(jg)) / grad_abs)
    fits, fits_lnl = case.lc_perturbed_fits(start, phases, w, lnx_abs,
                                            grad_abs)
    lim = tol.lcfit_limits(fits, fits_lnl, jp, jl, sigma)
    outcomes = (np.vstack([jp[None], fits]), np.concatenate([[jl],
                                                             fits_lnl]))
    tp, tl = tf.fit()
    out = {"value_over_sum": dv, "grad_over_S": dg.tolist(),
           "perturbed_moves_sigma": lim["moves"].tolist(),
           "perturbed_lnlike_moves": np.abs(fits_lnl - jl).tolist(),
           "fraction": lim["fraction"], "lnlike_limit": lim["lnlike"],
           "port_nearest_over_limit": tol.lcfit_nearest(tp, tl, *outcomes,
                                                        lim),
           "port_vs_jax_over_limit": tol.lcfit_nearest(tp, tl, jp, [jl],
                                                       lim)}
    if wrong:
        wf, wl = case.lc_wrong_fits(start, phases, w, grad_abs)
        out["wrong_moves_sigma"] = tol.lcfit_limits(
            wf, wl, jp, jl, sigma)["moves"].tolist()
        out["wrong_over_limit"] = [tol.lcfit_nearest(p, v, *outcomes, lim)
                                   for p, v in zip(wf, wl)]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wrong", action="store_true",
                    help="also fit with one gradient entry wrong")
    args = ap.parse_args(argv)
    for name, (lorentzian, widths) in TEMPLATES.items():
        print(json.dumps({name: readings(lorentzian, widths, args.wrong)}),
              flush=True)


if __name__ == "__main__":
    main()
