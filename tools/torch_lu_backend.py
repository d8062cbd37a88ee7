"""Time the GW sector's LU under each of PyTorch's CUDA linear-algebra
backends, on the card, at the 68-pulsar case's shapes.

``CommonProcess.lnlike_grid`` factors one (1904, 1904) matrix I + M Phi
per (log10 A, gamma) point with ``torch.linalg.lu_factor_ex`` over a
batch of points; ``lnlike`` factors one.  PyTorch picks the library
itself (``torch.backends.cuda.preferred_linalg_library``: "default",
"cusolver" or "magma").  This script runs the 16 x 16 grid and one
``lnlike`` under each choice, in turns (default, cusolver, magma,
magma, cusolver, default), checks every surface against the JAX answer
the case carries (1e-10 relative), and prints the wall time per call.
It changes nothing in the port.

Usage (on a machine with an NVIDIA GPU, from the repo root)::

    python tools/torch_lu_backend.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pint_tpu_torch import tolerances as tol  # noqa: E402
from pint_tpu_torch.convert import load_pta_case  # noqa: E402
from pint_tpu_torch.gw.os import OptimalStatistic  # noqa: E402

ORDER = ("default", "cusolver", "magma", "magma", "cusolver", "default")
REPS = 3


def _wall(fn):
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def main():
    if not torch.cuda.is_available():
        print("torch_lu_backend: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    arrays, pairs = load_pta_case()
    crn = OptimalStatistic(pairs, nmodes=int(arrays["ref_nmodes"]),
                           device="cuda").common_process()
    ga, gg = arrays["ref_grid_log10_amp"], arrays["ref_grid_gamma"]
    la, g = (float(x) for x in arrays["ref_lnlike_point"])
    before = torch.backends.cuda.preferred_linalg_library()
    times = {b: {"grid_s": [], "lnlike_s": []} for b in ORDER}
    try:
        for backend in ORDER:
            torch.backends.cuda.preferred_linalg_library(backend)
            crn.lnlike_grid(ga, gg)  # warm-up
            for _ in range(REPS):
                surf, t = _wall(lambda: crn.lnlike_grid(ga, gg))
                err = float(np.max(np.abs(surf / arrays["ref_grid_lnlike"]
                                          - 1)))
                if not err <= tol.GW_LNLIKE_REL:
                    raise AssertionError(f"{backend}: grid off by {err}")
                times[backend]["grid_s"].append(t)
                lnl, t = _wall(lambda: crn.lnlike(la, g))
                times[backend]["lnlike_s"].append(t)
    finally:
        torch.backends.cuda.preferred_linalg_library(before)
    n_pts = ga.size * gg.size
    out = {b: {"grid_median_s": float(np.median(v["grid_s"])),
               "points_per_s": n_pts / float(np.median(v["grid_s"])),
               "lnlike_median_s": float(np.median(v["lnlike_s"])),
               "grid_s": v["grid_s"], "lnlike_s": v["lnlike_s"]}
           for b, v in times.items()}
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
