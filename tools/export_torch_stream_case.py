"""Export the JAX CPU answers of the streaming appends on the committed
10k-TOA par/tim case, for the port's chip check.

Inputs: ``pint_tpu_torch/data/b1855_like.par``, ``b1855_white.par`` and
``b1855_epochs_10k.tim``.  Outputs:

- ``pint_tpu_torch/data/b1855_stream_nights.tim``: 11 nights of 25 TOAs
  made as ``bench.py:1723-1731`` (``bench_stream``) makes them: 1400
  MHz, ``-f L-wide``, gbt, 1 us, 0.2 d long, the first starting 1 d
  after the last TOA of the tim and each 3 d after the one before, the
  simulation's white noise from numpy seeds 1000 + i, under the par's
  model.  Night 10 has rows ``OUTLIER_ROWS`` moved by ``OUTLIER_US``.
  Both packages read the nights back from this file, so they append the
  same ticks;
- ``pint_tpu_torch/data/b1855_stream_answers.npz``, for ``gls`` (the par)
  and ``wls`` (the white par): ``GLSFitter`` / ``WLSFitter(toas, model,
  bucket=True)``, ``fit_toas(maxiter=3)``, ``stream_prepare()``, then
  ``append_refit(night, maxiter=3)`` for each night.  Per night:
  ``mode``, ``in_bucket``, the triage ``verdict``, the quarantined rows
  (a mask), ``margin`` (the smallest | |z| - 7 | of the night), ``chi2``,
  the values and uncertainties after the refit (free order), the
  captures it made (the recapture after the 8th refit) and
  ``cond_log10`` of the refit's normal matrix and ``centering``, the
  largest ratio of a raw to a mean-centered diagonal entry of its
  design block (both from the moments after it: the shift leaves the
  matrix alone).  JAX's own movement:
  ``chi2_moments_ulp_rel`` and ``chi2_start_ulp_rel``, how far each
  night's chi^2 moves, relative, when the stream runs again with every
  captured moment, or every fitted value it starts from, moved by one
  ulp (the largest over ``ULP_TRIALS`` random sign patterns).  Also the
  base fit's values and uncertainties, and a from-scratch fit
  (``maxiter=3``, bucketed)
  over the merged data as the stream holds it (quarantined rows at zero
  weight): ``scratch_values``, ``scratch_uncertainties``.

Usage (from the repo root, a few minutes on 8 CPU cores)::

    JAX_PLATFORMS=cpu python tools/export_torch_stream_case.py
"""

from __future__ import annotations

import copy
import os
import sys
import warnings

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pint_tpu_torch.convert import (B1855_PAR, B1855_STREAM_ANSWERS,  # noqa
                                    B1855_STREAM_NIGHTS, B1855_TIM,
                                    B1855_WHITE_PAR)
from tools.export_torch_case import _commit  # noqa: E402

N_NIGHTS = 11
NIGHT_TOAS = 25
OUTLIER_ROWS = (5, 17)
OUTLIER_US = 50.0
ULP_TRIALS = 3
MAXITER = 3


def make_nights(model, end_mjd):
    """The nights as bench_stream makes them; the last with two rows
    moved by OUTLIER_US."""
    from pint_tpu.simulation import make_fake_toas_uniform

    nights = []
    for i in range(N_NIGHTS):
        s0 = end_mjd + 1.0 + 3.0 * i
        t = make_fake_toas_uniform(
            s0, s0 + 0.2, NIGHT_TOAS, model, freq_mhz=1400.0, obs="gbt",
            error_us=1.0, add_noise=True,
            rng=np.random.default_rng(1000 + i), flags={"f": "L-wide"})
        nights.append(t)
    last = nights[-1]
    last.ticks = last.ticks.copy()
    last.ticks[list(OUTLIER_ROWS)] += np.int64(round(OUTLIER_US * 1e-6
                                                     * 2 ** 32))
    last._compute_posvels()
    return nights


def _cond(moments, center):
    """(cond_log10 of the refit's normal matrix, the centering ratio
    max_i a_qq[i, i] / a_jj[i, i]) from ``moments``."""
    from pint_tpu.fitter import _derive_blocks
    from pint_tpu.linalg import normal_solve_from_blocks

    blocks = _derive_blocks(moments, center)
    out = normal_solve_from_blocks(blocks, with_health=True)
    ratio = np.max(np.diag(np.asarray(moments.a_qq))
                   / np.diag(np.asarray(blocks.a_jj)))
    return float(out[4].cond_log10), float(ratio)


def _ulp(a, rng):
    """``a`` with each element moved by one ulp, up or down at random."""
    a = np.asarray(a, dtype=np.float64)
    return a + rng.choice([-1.0, 1.0], size=a.shape) * np.spacing(np.abs(a))


def run_stream(kind, model, toas, nights, perturb=None, seed=0):
    """JAX's stream; ``perturb`` "start" moves the fitted values, and
    "moments" the captured moments, by one ulp before the nights."""
    import jax.numpy as jnp

    from pint_tpu import telemetry
    from pint_tpu.fitter import GLSFitter, WLSFitter

    rng = np.random.default_rng(seed)
    cls = GLSFitter if kind == "gls" else WLSFitter
    m = copy.deepcopy(model)
    f = cls(toas, m, bucket=True)
    f.fit_toas(maxiter=MAXITER)
    free = list(m.free_params)
    out = {"free_params": np.asarray(free, dtype=np.str_),
           "base_values": np.asarray([m.values[k] for k in free]),
           "base_uncertainties": np.asarray([m.params[k].uncertainty
                                             for k in free]),
           "bucket": np.asarray(len(f.toas))}
    if perturb == "start":
        for k, v in zip(free, _ulp([m.values[k] for k in free], rng)):
            m.values[k] = float(v)
    f.stream_prepare()
    if perturb == "moments":
        mo = f._stream["moments"]
        f._stream["moments"] = type(mo)(**{
            k: jnp.asarray(_ulp(v, rng)) for k, v in mo._asdict().items()})
    rows = {k: [] for k in ("mode", "in_bucket", "verdict", "quarantine",
                            "margin", "chi2", "values", "uncertainties",
                            "captures", "cond_log10", "centering")}
    for night in nights:
        c0 = telemetry.counter_get("stream.captures")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rep = f.append_refit(night, maxiter=MAXITER)
        tri = rep["triage"]
        q = np.zeros(len(night), dtype=bool)
        q[tri["quarantine"]] = True
        rows["mode"].append(rep["mode"])
        rows["in_bucket"].append(bool(rep["in_bucket"]))
        rows["verdict"].append(tri["verdict"])
        rows["quarantine"].append(q)
        rows["margin"].append(float(np.min(np.abs(np.abs(tri["z"])
                                                  - tri["threshold"]))))
        rows["chi2"].append(float(rep["chi2"]))
        rows["values"].append([m.values[k] for k in free])
        rows["uncertainties"].append([m.params[k].uncertainty
                                      for k in free])
        rows["captures"].append(int(telemetry.counter_get("stream.captures")
                                    - c0))
        cond, ratio = _cond(f._stream["moments"],
                            bool(f.resids.subtract_mean))
        rows["cond_log10"].append(cond)
        rows["centering"].append(ratio)
    out.update({k: np.asarray(v) for k, v in rows.items()})
    return out, f


def stream(kind, model, toas, nights):
    out, f = run_stream(kind, model, toas, nights)
    free = list(out["free_params"])
    for i in range(len(nights)):
        print(f"{kind} night {i}: {out['mode'][i]} {out['verdict'][i]} "
              f"quarantine {np.flatnonzero(out['quarantine'][i]).tolist()} "
              f"margin {out['margin'][i]:.4f} chi2 {out['chi2'][i]!r} "
              f"captures {out['captures'][i]} cond "
              f"{out['cond_log10'][i]:.3f}", flush=True)
    for perturb in ("start", "moments"):
        moves = []
        for seed in range(ULP_TRIALS):
            o, _ = run_stream(kind, model, toas, nights, perturb, seed + 1)
            moves.append(np.abs(o["chi2"] / out["chi2"] - 1.0))
        out[f"chi2_{perturb}_ulp_rel"] = np.max(moves, axis=0)
        print(f"{kind}: chi2 per night under a one-ulp change of the "
              f"{perturb}: {out[f'chi2_{perturb}_ulp_rel'].tolist()}",
              flush=True)
    merged = f.toas[np.arange(f.toas.n_filled)]
    ms = copy.deepcopy(model)
    fs = type(f)(merged, ms, bucket=True)
    fs.fit_toas(maxiter=MAXITER)
    out["scratch_values"] = np.asarray([ms.values[k] for k in free])
    out["scratch_uncertainties"] = np.asarray(
        [ms.params[k].uncertainty for k in free])
    d = np.max(np.abs(out["values"][-1] - out["scratch_values"])
               / out["scratch_uncertainties"])
    print(f"{kind}: streamed final vs scratch {d!r} sigma", flush=True)
    return out


def main():
    from pint_tpu.models.builder import get_model, get_model_and_toas
    from pint_tpu.toa import TOAs, get_TOAs, write_tim

    model, toas = get_model_and_toas(str(B1855_PAR), str(B1855_TIM))
    white = get_model(str(B1855_WHITE_PAR))
    nights = make_nights(model, float(np.max(toas.mjd_float)))
    write_tim(TOAs.merge(nights), str(B1855_STREAM_NIGHTS))
    back = get_TOAs(str(B1855_STREAM_NIGHTS))
    nights = [back[np.arange(i * NIGHT_TOAS, (i + 1) * NIGHT_TOAS)]
              for i in range(N_NIGHTS)]
    out = {"commit": np.asarray(_commit()),
           "night_toas": np.asarray(NIGHT_TOAS),
           "outlier_rows": np.asarray(OUTLIER_ROWS),
           "outlier_us": np.asarray(OUTLIER_US)}
    for kind, m in (("gls", model), ("wls", white)):
        out.update({f"{kind}_{k}": v
                    for k, v in stream(kind, m, toas, nights).items()})
    np.savez_compressed(B1855_STREAM_ANSWERS, **out)
    print(f"wrote {B1855_STREAM_NIGHTS} and {B1855_STREAM_ANSWERS}")


if __name__ == "__main__":
    main()
