"""Count the ECORR epochs two GLS datasets form under pint_tpu.

- ``bench.py``'s ``bench_gls`` set: 10k TOAs, uniformly spaced per
  receiver (``_sim_two_band``);
- the port's epoch set (``tools/export_torch_case.py``): the same par
  and span, 200 epochs x 25 sub-band channels per receiver.

Prints, for each, the TOA count, the epochs carried as segments
(``Residuals.ecorr_segment_cols``), the shapes of the structured
basis blocks, and the EcorrNoise basis shape.  Usage (repo root)::

    JAX_PLATFORMS=cpu python tools/ecorr_epochs.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def describe(name, toas, model):
    from pint_tpu.linalg import StructuredU
    from pint_tpu.residuals import Residuals

    r = Residuals(toas, model)
    U = r._U_ext
    blocks = (f"pre {tuple(U.pre.shape)}, epochs {U.eslot.shape[0]}, "
              f"post {tuple(U.post.shape)}" if isinstance(U, StructuredU)
              else f"dense {tuple(U.shape)}")
    basis = r.prepared.ctx["EcorrNoise"]["basis"].shape
    print(f"{name}: {len(toas)} TOAs, ecorr_segment_cols "
          f"{r.ecorr_segment_cols}, U {blocks}, EcorrNoise basis "
          f"{tuple(basis)}")


def main():
    import bench
    from tools.export_torch_case import b1855_model, epoch_toas

    model = b1855_model()
    describe("bench_gls (bench.py:_sim_two_band)",
             bench._sim_two_band(model, 10000), model)
    describe("port epoch set (200 epochs x 25 channels x 2)",
             epoch_toas(model, 200, 25, seed=0), model)


if __name__ == "__main__":
    main()
