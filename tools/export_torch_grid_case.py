"""Export the JAX CPU answers of the chi^2 grids and the downhill fitters
on the committed 10k-TOA par/tim case, for the port's chip check.

Inputs: ``pint_tpu_torch/data/b1855_like.par`` and
``b1855_epochs_10k.tim`` (``tools/export_torch_tim_case.py``), and the
WLS uncertainties of F0 and F1 stored beside them in
``b1855_epochs_10k_answers.npz``.  Outputs:

- ``pint_tpu_torch/data/b1855_white.par``: the same par without its
  ECORR and TNRed lines (EFAC/EQUAD kept), so a fit of it takes the WLS
  branch;
- ``pint_tpu_torch/data/b1855_grid_answers.npz``:

  * ``gls_*``: ``pint_tpu.grid.make_grid_fn(toas, model, ["M2",
    "SINI"], n_steps=3)`` over the 16 x 16 axes of ``bench.py:388-390``
    (M2 = 0.26 + linspace(-2, 2, 16) 0.0075, SINI = 0.999 +
    linspace(-2, 2, 16) 0.0002): the points (256, 2), chi^2 (256,) and
    the refit parameters (256, 8) with their names, and ``chi2_next``,
    the chi^2 after one more Gauss-Newton step (how far a 3-step
    refit's chi^2 still moves);
  * ``wls_*``: the same for ["F0", "F1"] on the white par, 16 x 16 axes
    of +-3 sigma around the par's values (sigma: the stored WLS
    uncertainties).  F0's sigma, 5.4e-14 Hz, is below two float64 ulps
    at 186 Hz (2.8e-14), so its 16 values land on fewer distinct doubles
    (the chi^2 surface is still sampled across +-3 sigma);
  * ``downhill_gls_*`` / ``downhill_wls_*``: ``DownhillGLSFitter`` on
    the par and ``DownhillWLSFitter`` on the white par, both from
    ``DOWNHILL_START`` (SINI = 0.995, where the full first Gauss-Newton
    step carries SINI past 1, chi^2 NaN, and lambda = 1/2 is taken;
    every later step is a full one): the accepted chi^2 and the lambda
    of each iteration, the iteration count, ``converged``, the final
    chi^2, and the fitted values and uncertainties in fit order;
  * ``downhill99_gls_*`` / ``downhill99_wls_*``: the same from
    ``WITNESS_START`` (SINI = 0.99), whose last iteration proposes a
    step at the noise floor: whether it is taken, halved or refused
    turns on chi^2 differences of ~1e-9 relative.  Beside it, the
    witness of that: JAX's lambdas from the two starts one ulp either
    side (``ulp_lambdas``) and how far those fits land from the 0.99
    one (``ulp_values_sigma``, in sigma; ``ulp_chi2_rel``, each
    iteration's chi^2, relative).

JAX records no lambda: each is read off the fit as the least-squares
ratio of the step taken to the full Gauss-Newton step proposed at the
same parameters, rounded to the nearest power of two (0 for a step not
taken).

The grids run in chunks of ``--chunk`` points (the answers do not depend
on it).  Usage (from the repo root, ~5 min on 8 CPU cores)::

    JAX_PLATFORMS=cpu python tools/export_torch_grid_case.py
"""

from __future__ import annotations

import argparse
import copy
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pint_tpu_torch.convert import (B1855_GRID_ANSWERS,  # noqa: E402
                                    B1855_PAR, B1855_TIM,
                                    B1855_TIM_ANSWERS, B1855_WHITE_PAR)
from tools.export_torch_case import _commit  # noqa: E402

GLS_GRID = ("M2", "SINI")
WLS_GRID = ("F0", "F1")
N_STEPS = 3
#: the downhill fits' start: SINI moved from its par value 0.999
DOWNHILL_START = {"SINI": 0.995}
#: the start whose last step is decided at the noise floor
WITNESS_START = {"SINI": 0.99}


def white_par(text: str) -> str:
    """The par without its correlated-noise lines (ECORR, TNRed*)."""
    keep = [ln for ln in text.splitlines()
            if not ln.split() or not (ln.split()[0] == "ECORR"
                                      or ln.split()[0].startswith("TNRed"))]
    return "\n".join(keep) + "\n"


def gls_axes(n=16):
    """The (M2, SINI) axes of bench.py:388-390."""
    s = np.linspace(-2.0, 2.0, n)
    return 0.26 + s * 0.0075, 0.999 + s * 0.0002


def wls_axes(values, sigmas, n=16):
    """+-3 sigma axes around ``values`` (one per gridded parameter)."""
    s = np.linspace(-3.0, 3.0, n)
    return [v + s * e for v, e in zip(values, sigmas)]


def mesh(axes):
    a, b = np.meshgrid(*axes, indexing="ij")
    return np.stack([a.ravel(), b.ravel()], axis=1)

def _grid(toas, model, names, points, chunk):
    from pint_tpu.grid import make_grid_fn

    def run(n_steps):
        fn, fit_params, _ = make_grid_fn(toas, model, list(names),
                                         n_steps=n_steps)
        outs = [fn(points[i:i + chunk])
                for i in range(0, len(points), chunk)]
        return (fit_params,
                np.concatenate([np.asarray(o[0]) for o in outs]),
                np.concatenate([np.asarray(o[1]) for o in outs]))

    fit_params, chi2, fitted = run(N_STEPS)
    return {"points": points, "chi2": chi2, "fitted": fitted,
            "fit_params": np.asarray(fit_params, dtype=np.str_),
            "chi2_next": run(N_STEPS + 1)[1]}


def _lambda(taken, dpar):
    """A step's lambda: taken / dpar by least squares, rounded to the
    nearest power of two (0 for no step)."""
    lam = float(taken @ dpar / (dpar @ dpar))
    return 0.0 if lam <= 0.0 else float(2.0 ** np.round(np.log2(lam)))


def _downhill(cls, toas, model, start):
    import jax
    import jax.numpy as jnp

    m = copy.deepcopy(model)
    m.values.update(start)
    old = os.environ.get("PINT_TPU_ITER_TRACE")
    os.environ["PINT_TPU_ITER_TRACE"] = "1"
    try:
        f = cls(toas, m)
        steps, note = [], f._note_iteration

        def record(chi2_f, vec_in, vec_new, *rest):
            steps.append((np.array(vec_in), np.array(vec_new)))
            return note(chi2_f, vec_in, vec_new, *rest)

        f._note_iteration = record
        final = f.fit_toas()
    finally:
        if old is None:
            os.environ.pop("PINT_TPU_ITER_TRACE", None)
        else:
            os.environ["PINT_TPU_ITER_TRACE"] = old
    propose = jax.jit(f._propose)
    base, data = f.prepared._values_pytree(), f._guard_data(0.0)
    lambdas = [_lambda(new - vin,
                       np.asarray(propose(jnp.asarray(vin), base, data)[2]))
               for vin, new in steps]
    free = list(m.free_params)
    chi2 = np.asarray([e["chi2"] for e in f.iter_trace], np.float64)
    return {"chi2_iters": chi2, "n_iter": np.asarray(len(chi2)),
            "lambdas": np.asarray(lambdas, np.float64),
            "converged": np.asarray(bool(f.converged)),
            "final_chi2": np.asarray(final, np.float64),
            "free_params": np.asarray(free, dtype=np.str_),
            "values": np.asarray([m.values[k] for k in free], np.float64),
            "uncertainties": np.asarray(
                [m.params[k].uncertainty for k in free], np.float64)}


def _witness(cls, toas, model):
    """The downhill fit from WITNESS_START and, beside it, JAX's own
    spread under a one-ulp change of that start."""
    (name, v0), = WITNESS_START.items()
    w = _downhill(cls, toas, model, WITNESS_START)
    ulp = [_downhill(cls, toas, model, {name: float(np.nextafter(v0, to))})
           for to in (2.0, 0.0)]
    w["ulp_lambdas"] = np.asarray([u["lambdas"] for u in ulp])
    w["ulp_values_sigma"] = np.asarray(max(
        float(np.max(np.abs(u["values"] - w["values"])
                     / w["uncertainties"])) for u in ulp))
    w["ulp_chi2_rel"] = np.asarray(max(
        float(np.max(np.abs(u["chi2_iters"] / w["chi2_iters"] - 1)))
        for u in ulp))
    return w


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunk", type=int, default=16)
    args = ap.parse_args(argv)

    from pint_tpu.downhill import DownhillGLSFitter, DownhillWLSFitter
    from pint_tpu.models.builder import get_model, get_model_and_toas

    B1855_WHITE_PAR.write_text(white_par(B1855_PAR.read_text()))
    model, toas = get_model_and_toas(str(B1855_PAR), str(B1855_TIM))
    white = get_model(str(B1855_WHITE_PAR))
    ref = np.load(B1855_TIM_ANSWERS)
    free = [str(p) for p in ref["free_params"]]
    sig = [float(ref["wls_uncertainties"][free.index(k)]) for k in WLS_GRID]

    out = {"n_steps": np.asarray(N_STEPS), "commit": np.asarray(_commit())}
    axes = {"gls": (model, gls_axes()),
            "wls": (white, wls_axes([white.values[k] for k in WLS_GRID],
                                    sig))}
    for kind, names in (("gls", GLS_GRID), ("wls", WLS_GRID)):
        m, ax = axes[kind]
        g = _grid(toas, m, names, mesh(ax), args.chunk)
        out.update({f"{kind}_{k}": v for k, v in g.items()})
        move = float(np.max(np.abs(g["chi2_next"] / g["chi2"] - 1)))
        print(f"{kind} grid: chi2 {g['chi2'].min():.6f} .. "
              f"{g['chi2'].max():.6f}; one more step moves it {move!r} "
              "relative", flush=True)
    for name, cls, m in (("gls", DownhillGLSFitter, model),
                         ("wls", DownhillWLSFitter, white)):
        d = _downhill(cls, toas, m, DOWNHILL_START)
        out.update({f"downhill_{name}_{k}": v for k, v in d.items()})
        print(f"downhill {name}: lambdas {d['lambdas'].tolist()}, chi2 per "
              f"iteration {d['chi2_iters'].tolist()}, converged "
              f"{bool(d['converged'])}", flush=True)
        w = _witness(cls, toas, m)
        out.update({f"downhill99_{name}_{k}": v for k, v in w.items()})
        print(f"downhill {name} from {WITNESS_START}: lambdas "
              f"{w['lambdas'].tolist()}, one ulp either side "
              f"{w['ulp_lambdas'].tolist()}; those fits differ by "
              f"{float(w['ulp_values_sigma'])!r} sigma, their chi2 per "
              f"iteration by {float(w['ulp_chi2_rel'])!r}", flush=True)
    for key, start in (("downhill_start", DOWNHILL_START),
                       ("downhill99_start", WITNESS_START)):
        out[key] = np.asarray([[k, repr(v)] for k, v in start.items()],
                              dtype=np.str_)
    np.savez_compressed(B1855_GRID_ANSWERS, **out)
    print(f"wrote {B1855_WHITE_PAR} and {B1855_GRID_ANSWERS}")


if __name__ == "__main__":
    main()
