"""Export a (model, TOAs) pair from ``pint_tpu`` as the plain-array case
that ``pint_tpu_torch.convert.case_from_arrays`` loads, together with
the JAX CPU answers of a ``GLSFitter.fit_toas`` run beside it.

The case carries everything the port's GLS fit starts from:

- the TOA table (``toa_*``): exact int64 ticks, observing frequency,
  error, the observatory geometry, and each flag as an index into a
  names array (``flag_<key>_index`` / ``flag_<key>_names``, -1 where a
  TOA lacks the flag);
- the TZR reference row (``tzr_*``) in the same layout;
- every ``model.values`` entry as float64, the exact ``epoch_ticks``
  as int64, the component spec (class names, mask selects, derivative
  counts) as JSON, and the free parameters in fit order;
- the reference answers (``ref_*``): prefit time residuals, the chi^2
  of each Gauss-Newton iteration, the fitted values and uncertainties,
  the final chi^2 and the commit that produced them.

Written with ``np.savez_compressed`` and no object arrays, so the file
loads with ``allow_pickle=False``.

Usage (from the repo root)::

    JAX_PLATFORMS=cpu python tools/export_torch_case.py \\
        --epochs 200 --channels 25 --seed 0 \\
        --out pint_tpu_torch/data/b1855_epochs_10k.npz
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

#: receivers of the epoch dataset: (flag, band edges MHz, error us,
#: MJD offset of the receiver's epochs)
RECEIVERS = (
    ("L-wide", (1150.0, 1750.0), 1.0, 0.0),
    ("S-wide", (1900.0, 2700.0), 1.5, 0.01),
)

#: constructor arguments of each component class the port models
_SPEC_ATTRS = ("selects", "efac_selects", "equad_selects", "tneq_selects",
               "num_freq_derivs", "num_dm_derivs", "fb_terms", "_use_rn")


def b1855_model():
    """The B1855-like DD-binary model that ``bench.py`` fits."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from bench import B1855_LIKE_PAR
    from pint_tpu.models.builder import get_model

    return get_model(B1855_LIKE_PAR)


def epoch_toas(model, n_epochs, n_chan, seed=0, span=(53000.0, 56500.0)):
    """Two-receiver narrowband TOAs: ``n_epochs`` observing epochs per
    receiver, each split into ``n_chan`` sub-band TOAs at one arrival
    time, so every epoch forms one ECORR block."""
    from pint_tpu.simulation import make_fake_toas_uniform
    from pint_tpu.toa import TOAs

    rng = np.random.default_rng(seed)
    parts = []
    for flag, (lo, hi), err_us, off in RECEIVERS:
        parts.append(make_fake_toas_uniform(
            span[0] + off, span[1] + off, n_epochs, model,
            freq_mhz=np.linspace(lo, hi, n_chan), obs="gbt",
            error_us=err_us, add_noise=True, rng=rng,
            flags={"f": flag}, multifreq=True))
    return TOAs.merge(parts)


def _table_arrays(prefix, toas):
    if toas.planets:
        raise NotImplementedError(
            "planet positions are not carried across: the port computes "
            "the solar-system Shapiro delay of the Sun only")
    out = {
        f"{prefix}ticks": np.asarray(toas.ticks, dtype=np.int64),
        f"{prefix}freq_mhz": np.asarray(toas.freq_mhz, dtype=np.float64),
        f"{prefix}error_us": np.asarray(toas.error_us, dtype=np.float64),
        f"{prefix}mjd_float": np.asarray(toas.mjd_float, dtype=np.float64),
        f"{prefix}ssb_obs_pos": np.asarray(toas.ssb_obs_pos, np.float64),
        f"{prefix}ssb_obs_vel": np.asarray(toas.ssb_obs_vel, np.float64),
        f"{prefix}obs_sun_pos": np.asarray(toas.obs_sun_pos, np.float64),
    }
    keys = sorted({k for f in toas.flags for k in f})
    out[f"{prefix}flag_keys"] = np.asarray(keys, dtype=np.str_)
    for k in keys:
        names = sorted({str(f[k]) for f in toas.flags if k in f})
        lut = {n: i for i, n in enumerate(names)}
        out[f"{prefix}flag_{k}_names"] = np.asarray(names, dtype=np.str_)
        out[f"{prefix}flag_{k}_index"] = np.asarray(
            [lut[str(f[k])] if k in f else -1 for f in toas.flags],
            dtype=np.int32)
    return out


def _component_spec(model):
    spec = []
    for c in model.components:
        args = {}
        for a in _SPEC_ATTRS:
            if hasattr(c, a):
                v = getattr(c, a)
                args[a.lstrip("_")] = (
                    [list(s) for s in v] if isinstance(v, tuple) else v)
        spec.append({"class": type(c).__name__, "args": args})
    return spec


def tzr_toas(model, toas):
    """The TZR reference TOA the JAX PreparedModel builds."""
    comp = model.component("AbsPhase")
    return comp.make_tzr_toas(model, toas)


def case_arrays(model, toas):
    """The plain-array case for (model, toas), reference answers not
    included."""
    tzr = tzr_toas(model, toas)
    names = list(model.values)
    arrays = {}
    arrays.update(_table_arrays("toa_", toas))
    arrays.update(_table_arrays("tzr_", tzr))
    arrays["value_names"] = np.asarray(names, dtype=np.str_)
    arrays["value_vals"] = np.asarray(
        [float(model.values[k]) for k in names], dtype=np.float64)
    et = getattr(model, "epoch_ticks", {})
    arrays["epoch_names"] = np.asarray(list(et), dtype=np.str_)
    arrays["epoch_ticks"] = np.asarray(
        [int(v) for v in et.values()], dtype=np.int64)
    arrays["spec_json"] = np.asarray(json.dumps(_component_spec(model)))
    arrays["free_params"] = np.asarray(list(model.free_params),
                                       dtype=np.str_)
    arrays["psr"] = np.asarray(model.meta.get("PSR", ""))
    return arrays


def _commit():
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def reference_answers(model, toas, maxiter=3):
    """Fit a COPY of ``model`` with the JAX GLSFitter and return the
    ``ref_*`` arrays.  The flight recorder is switched on for the fit
    so the chi^2 of every iteration is recorded."""
    import copy

    from pint_tpu.fitter import GLSFitter
    from pint_tpu.residuals import Residuals

    m = copy.deepcopy(model)
    prefit = np.asarray(Residuals(toas, m).time_resids, dtype=np.float64)
    old = os.environ.get("PINT_TPU_ITER_TRACE")
    os.environ["PINT_TPU_ITER_TRACE"] = "1"
    try:
        f = GLSFitter(toas, m)
        final = f.fit_toas(maxiter=maxiter)
    finally:
        if old is None:
            os.environ.pop("PINT_TPU_ITER_TRACE", None)
        else:
            os.environ["PINT_TPU_ITER_TRACE"] = old
    free = list(m.free_params)
    params = m.params
    return {
        "ref_prefit_time_resids": prefit,
        "ref_chi2_iters": np.asarray([e["chi2"] for e in f.iter_trace],
                                     dtype=np.float64),
        "ref_fitted_values": np.asarray([m.values[k] for k in free],
                                        dtype=np.float64),
        "ref_uncertainties": np.asarray(
            [params[k].uncertainty for k in free], dtype=np.float64),
        "ref_final_chi2": np.asarray(final, dtype=np.float64),
        "ref_ecorr_epochs": np.asarray(f.resids.ecorr_segment_cols),
        "ref_maxiter": np.asarray(maxiter),
        "ref_commit": np.asarray(_commit()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--channels", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--maxiter", type=int, default=3)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    model = b1855_model()
    toas = epoch_toas(model, a.epochs, a.channels, seed=a.seed)
    arrays = case_arrays(model, toas)
    arrays.update(reference_answers(model, toas, maxiter=a.maxiter))
    np.savez_compressed(a.out, **arrays)
    print(f"wrote {a.out}: {len(toas)} TOAs, "
          f"{int(arrays['ref_ecorr_epochs'])} ECORR epochs, chi2 per "
          f"iteration {arrays['ref_chi2_iters'].tolist()}")


if __name__ == "__main__":
    main()
