"""Export pint_tpu's dense common-red-noise likelihood
(``CommonProcess(..., kron=False)``) on the pta68_500 array, the answers
``chip_smoke.py``'s ``crn dense`` phase holds the port's dense path to.

The array is ``tools/export_torch_pta_case.make_pta(68, 500, seed=0)``,
the one ``pint_tpu_torch/data/pta68_500.npz`` carries, built once with
``build_pulsar_data(nmodes=14)``.  Stored (``ref_*``):

- ``ref_points`` (n, 2): the (log10 A, gamma) points, the case's point
  (-13.7, 13/3) first;
- ``ref_hd_dense`` (n,): the dense Hellings-Downs ``lnlike`` there, and
  ``ref_hd_kron`` (n,): the kron path's at the same points (the
  reference's kron == dense pin at full width);
- ``ref_monopole_dense``, ``ref_dipole_dense`` (and ``_kron``): the
  case's point under the singular ORFs;
- ``ref_kron_case_lnlike``: the kron answer the case file carries at its
  point (the build reproduces the case when they are equal);
- ``ref_seconds``: this tool's wall time per dense point, and the
  commit.

At K = 6188 basis columns and 34000 TOAs each dense point forms a
(K, K) prior, its inverse and the capacity's Cholesky (~5e11 flop) and
holds ~6 GB.

Usage (from the repo root, ~10 min on 8 CPU cores)::

    JAX_PLATFORMS=cpu python tools/export_torch_crn_dense_case.py \\
        --out pint_tpu_torch/data/crn_dense_answers.npz
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
from tools.export_torch_pta_case import GWB_GAMMA, make_pta  # noqa: E402

#: the case's point, then two more inside its grid's box
POINTS = np.asarray([[-13.7, GWB_GAMMA], [-14.4, 3.0], [-13.9, 5.5]])


def dense_answers(pairs, nmodes=14, points=POINTS):
    """The ``ref_*`` arrays (JAX on the CPU)."""
    from pint_tpu.gw import CommonProcess
    from pint_tpu.gw.common import build_pulsar_data

    t0 = time.time()
    data, pos, freqs, df, _ = build_pulsar_data(pairs, nmodes=nmodes)
    print(f"build {time.time() - t0:.1f} s", file=sys.stderr)
    out = {"ref_points": points, "ref_nmodes": np.asarray(nmodes)}
    seconds = []
    for orf in ("hd", "monopole", "dipole"):
        pts = points if orf == "hd" else points[:1]
        dense = CommonProcess(nmodes=nmodes, orf=orf, kron=False,
                              _prebuilt=(data, pos, freqs, df))
        kron = CommonProcess(nmodes=nmodes, orf=orf, kron=True,
                             _prebuilt=(data, pos, freqs, df))
        got_d, got_k = [], []
        for la, g in pts:
            t1 = time.time()
            got_d.append(dense.lnlike(float(la), float(g)))
            seconds.append(time.time() - t1)
            got_k.append(kron.lnlike(float(la), float(g)))
            print(f"{orf} ({la}, {g}): dense {got_d[-1]!r} kron "
                  f"{got_k[-1]!r} rel {abs(got_d[-1] / got_k[-1] - 1):.3e}"
                  f" ({seconds[-1]:.1f} s)", file=sys.stderr)
        out[f"ref_{orf}_dense"] = np.asarray(got_d)
        out[f"ref_{orf}_kron"] = np.asarray(got_k)
        del dense
    out["ref_seconds"] = np.asarray(seconds)
    out["ref_commit"] = np.asarray(_commit())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", default=os.path.join(
        "pint_tpu_torch", "data", "pta68_500.npz"))
    ap.add_argument("--n-psr", type=int, default=68)
    ap.add_argument("--ntoa", type=int, default=500)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    t0 = time.time()
    pairs = make_pta(a.n_psr, a.ntoa, seed=0)
    out = dense_answers(pairs)
    with np.load(a.case) as case:
        out["ref_kron_case_lnlike"] = np.asarray(case["ref_lnlike"])
    print(f"kron at the case's point: {float(out['ref_hd_kron'][0])!r}, "
          f"the case file's {float(out['ref_kron_case_lnlike'])!r}",
          file=sys.stderr)
    np.savez_compressed(a.out, **out)
    print(f"wrote {a.out} in {time.time() - t0:.1f} s: HD dense "
          f"{out['ref_hd_dense'].tolist()}")


if __name__ == "__main__":
    main()
