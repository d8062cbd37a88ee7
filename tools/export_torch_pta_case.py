"""Export a synthetic pulsar-timing array from ``pint_tpu`` as the
plain-array PTA case that ``pint_tpu_torch.convert.load_pta_case``
loads, with the JAX CPU answers of the GW path beside it.

The array is ``make_fake_pta(68, 500, seed=0, duration_days=4570)``
with 30-mode power-law intrinsic red noise on every pulsar and one
Hellings-Downs-correlated GWB realization injected at A = 2e-14,
gamma = 13/3 over 14 common modes (``add_gwb`` on the disjoint
injection stream ``pta_injection_seed(0, 68)``).  Pulsar ``i``'s case
arrays (``tools/export_torch_case.case_arrays``) are stored under the
prefix ``p{i:02d}_``.  The reference answers (``ref_*``):

- the optimal statistic (``OptimalStatistic(pairs, nmodes=14)``):
  ``ahat2``, ``snr``, ``sigma_ahat2`` and the per-pair ``rho``, ``sig``;
- ``noise_marginalized`` over 32 seeded draws of every pulsar's
  intrinsic red-noise (log10 A, gamma), the draws stored beside it;
- the kron-structured GWB likelihood (``kron=True``, pinned, not read
  from ``$PINT_TPU_KRON_PHI``) at (-13.7, 13/3) and on the 16 x 16
  grid log10 A in [-15, -13.5], gamma in [2, 6];
- the commit that produced them.

The grid is evaluated one log10 A row at a time, so the JAX program
holds 16 (1904, 1904) systems at once, not 256.

Usage (from the repo root, ~2 min on 8 CPU cores)::

    JAX_PLATFORMS=cpu python tools/export_torch_pta_case.py \\
        --out pint_tpu_torch/data/pta68_500.npz
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tools.export_torch_case import _commit, case_arrays  # noqa: E402

RED_PAR = "TNRedAmp -13.7\nTNRedGam 4.33\nTNRedC 30\n"
GWB_GAMMA = 13.0 / 3.0
GRID_LOG10_A = np.linspace(-15.0, -13.5, 16)
GRID_GAMMA = np.linspace(2.0, 6.0, 16)


def make_pta(n_psr=68, ntoa=500, seed=0, duration_days=4570.0,
             extra_par=RED_PAR, gwb_amp=2e-14, gwb_nmodes=14):
    """``[(model, toas), ...]`` of the synthetic array, GWB injected."""
    from pint_tpu.simulation import add_gwb, make_fake_pta, \
        pta_injection_seed

    pairs = make_fake_pta(n_psr, ntoa, seed=seed,
                          duration_days=duration_days, extra_par=extra_par)
    add_gwb([t for _, t in pairs], [m for m, _ in pairs], gwb_amp,
            rng=pta_injection_seed(seed, n_psr), nmodes=gwb_nmodes)
    return pairs


def pta_case_arrays(pairs) -> dict:
    """Every pulsar's case arrays under its ``p{i:02d}_`` prefix."""
    out = {"n_psr": np.asarray(len(pairs))}
    for i, (m, t) in enumerate(pairs):
        for k, v in case_arrays(m, t).items():
            out[f"p{i:02d}_{k}"] = v
    return out


def noise_draws(n_draws, n_psr, seed=0):
    """(log10 A, gamma) draws of every pulsar's intrinsic red noise,
    (n_draws, n_psr) each, scattered around the injected values."""
    rng = np.random.default_rng(seed)
    amps = -13.7 + 0.3 * rng.standard_normal((n_draws, n_psr))
    gams = 4.33 + 0.5 * rng.standard_normal((n_draws, n_psr))
    return amps, gams


def reference_answers(pairs, nmodes=14, n_draws=32, grid=True):
    """The ``ref_*`` arrays of the GW path (JAX on the CPU)."""
    from pint_tpu.gw import CommonProcess, OptimalStatistic

    t0 = time.time()
    ost = OptimalStatistic(pairs, nmodes=nmodes)
    res = ost.compute()
    t_os = time.time() - t0
    amps, gams = noise_draws(n_draws, len(pairs))
    m_ahat2, m_snr, m_sig = ost.noise_marginalized(amps, gams)
    crn = CommonProcess(nmodes=nmodes, orf="hd", kron=True,
                        _prebuilt=(ost.data, ost.pos, ost.freqs, ost.df))
    lnl = crn.lnlike(-13.7, GWB_GAMMA)
    out = {
        "ref_nmodes": np.asarray(nmodes),
        "ref_os_ahat2": np.asarray(res.ahat2),
        "ref_os_snr": np.asarray(res.snr),
        "ref_os_sigma_ahat2": np.asarray(res.sigma_ahat2),
        "ref_os_rho": np.asarray(res.rho),
        "ref_os_sig": np.asarray(res.sig),
        "ref_draws_log10_amp": amps, "ref_draws_gamma": gams,
        "ref_marg_ahat2": np.asarray(m_ahat2),
        "ref_marg_snr": np.asarray(m_snr),
        "ref_marg_sigma_ahat2": np.asarray(m_sig),
        "ref_lnlike_point": np.asarray([-13.7, GWB_GAMMA]),
        "ref_lnlike": np.asarray(lnl),
        "ref_commit": np.asarray(_commit()),
    }
    if grid:
        rows = [crn.lnlike_grid(GRID_LOG10_A[i:i + 1], GRID_GAMMA)[0]
                for i in range(len(GRID_LOG10_A))]
        out.update({"ref_grid_log10_amp": GRID_LOG10_A,
                    "ref_grid_gamma": GRID_GAMMA,
                    "ref_grid_lnlike": np.stack(rows)})
    print(f"reference: OS build+compute {t_os:.1f} s, total "
          f"{time.time() - t0:.1f} s", file=sys.stderr)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-psr", type=int, default=68)
    ap.add_argument("--ntoa", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    pairs = make_pta(a.n_psr, a.ntoa, seed=a.seed)
    arrays = pta_case_arrays(pairs)
    arrays.update(reference_answers(pairs))
    np.savez_compressed(a.out, **arrays)
    print(f"wrote {a.out}: {a.n_psr} pulsars x {a.ntoa} TOAs, OS ahat2 "
          f"{float(arrays['ref_os_ahat2']):.6e} snr "
          f"{float(arrays['ref_os_snr']):.4f}, lnlike "
          f"{float(arrays['ref_lnlike']):.6f}")


if __name__ == "__main__":
    main()
