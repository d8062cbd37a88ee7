"""Export the heterogeneous PTA batch of ``bench.py:486 bench_pta`` from
``pint_tpu`` as the plain-array PTA case that
``pint_tpu_torch.convert.load_pta_case`` loads, with the JAX CPU answers
of ``PTABatch`` beside it.

The array is ``bench_pta``'s generator with its binaries cut to the
isolated and DD entries (``kind = i % 2``; the ELL1, DDK and wideband
members wait for the port's ELL1/DDK and wideband items): 68 pulsars x
500 TOAs at ``gbt`` from MJD 53000 to 56000, 1400/800 MHz alternating,
1 us errors with white noise from ``default_rng(i)``, F0 from one
``default_rng(0)`` stream, EFAC/EQUAD/ECORR on ``-f L-wide`` and 30-mode
power-law red noise on every pulsar; the free union is F0, F1, DM, PB,
A1, T0, ECC, OM.  500 uniform TOAs over 3000 days form no ECORR epoch.
Pulsar ``i``'s case arrays (``tools/export_torch_case.case_arrays``) are
stored under the prefix ``p{i:02d}_``.  The reference answers
(``ref_*``), each from a fresh ``PTABatch(pairs)``:

- ``residuals()`` (68, n_max) and ``chisq()`` (68,) at the start;
- ``fit_wls(maxiter=3)`` and ``fit_gls(maxiter=3)``: fitted values
  (68, 8), chi^2 (68,), covariance (68, 8, 8), and the rung that served
  them (``"baseline"``: the reference's guard is on);
- the free-name union, its free mask, and the commit.

Usage (from the repo root, ~1 min on 8 CPU cores)::

    JAX_PLATFORMS=cpu python tools/export_torch_pta_batch_case.py \\
        --out pint_tpu_torch/data/pta68_500_batch.npz
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tools.export_torch_case import _commit  # noqa: E402
from tools.export_torch_pta_case import pta_case_arrays  # noqa: E402

#: bench_pta's members the port takes: isolated and DD
BINARIES = [
    "",
    "BINARY DD\nPB 8.3 1\nA1 6.1 1\nT0 54500.2 1\nECC 0.17 1\n"
    "OM 110.0 1\n",
]
NOISE = ("EFAC -f L-wide 1.1\nEQUAD -f L-wide 0.4\n"
         "ECORR -f L-wide 0.6\nTNRedAmp -13.0\nTNRedGam 3.0\n"
         "TNRedC 30\n")


def make_pairs(n_psr=68, n_toas=500):
    """``[(model, toas), ...]`` of bench_pta's generator, isolated and DD
    members alternating."""
    from pint_tpu.models.builder import get_model
    from pint_tpu.simulation import make_fake_toas_uniform

    rng = np.random.default_rng(0)
    pairs = []
    for i in range(n_psr):
        f0 = 100.0 + 400.0 * rng.random()
        kind = i % len(BINARIES)
        par = (f"PSR FAKE{i:02d}\nRAJ {i % 24:02d}:10:00\n"
               f"DECJ {(i * 3) % 60 - 30:+03d}:00:00\nF0 {f0!r} 1\n"
               f"F1 -1e-15 1\nPEPOCH 54500\nDM {10 + i * 0.5} 1\n"
               "TZRMJD 54500\nTZRSITE @\nTZRFRQ 1400\n"
               "UNITS TDB\nEPHEM builtin\n") + BINARIES[kind] + NOISE
        m = get_model(par)
        t = make_fake_toas_uniform(
            53000, 56000, n_toas, m, obs="gbt", error_us=1.0,
            add_noise=True, rng=np.random.default_rng(i),
            freq_mhz=np.where(np.arange(n_toas) % 2 == 0, 1400.0, 800.0),
            wideband=False, dm_error=2e-4, flags={"f": "L-wide"})
        pairs.append((m, t))
    return pairs


def reference_answers(pairs, maxiter=3):
    """The ``ref_*`` arrays (JAX on the CPU)."""
    from pint_tpu.parallel.pta import PTABatch

    out = {}
    t0 = time.time()
    batch = PTABatch(pairs)
    out["ref_free_names"] = np.asarray(batch.free_names, dtype=np.str_)
    out["ref_free_mask"] = np.asarray(batch.free_mask)
    out["ref_values0"] = np.asarray(batch.values0)
    out["ref_residuals"] = np.asarray(batch.residuals())
    out["ref_chisq"] = np.asarray(batch.chisq())
    for kind in ("wls", "gls"):
        b = PTABatch(pairs)
        vec, chi2, cov = getattr(b, f"fit_{kind}")(maxiter=maxiter)
        out[f"ref_{kind}_values"] = np.asarray(vec)
        out[f"ref_{kind}_chi2"] = np.asarray(chi2)
        out[f"ref_{kind}_cov"] = np.asarray(cov)
        out[f"ref_{kind}_rung"] = np.asarray(b.fit_rung)
    out["ref_maxiter"] = np.asarray(maxiter)
    out["ref_commit"] = np.asarray(_commit())
    print(f"reference: {time.time() - t0:.1f} s", file=sys.stderr)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-psr", type=int, default=68)
    ap.add_argument("--ntoa", type=int, default=500)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    pairs = make_pairs(a.n_psr, a.ntoa)
    arrays = pta_case_arrays(pairs)
    arrays.update(reference_answers(pairs))
    np.savez_compressed(a.out, **arrays)
    print(f"wrote {a.out}: {a.n_psr} pulsars x {a.ntoa} TOAs, free "
          f"{arrays['ref_free_names'].tolist()}, rungs "
          f"{arrays['ref_wls_rung']}/{arrays['ref_gls_rung']}")


if __name__ == "__main__":
    main()
