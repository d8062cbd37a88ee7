"""Fake TOAs with zero (or white-noise) residuals (pint_tpu
simulation.py:59-165).

The phase inversion runs the port's residuals on ``device`` (CUDA
unless given); the noise draws use numpy's generator, so a seed gives
the JAX package's TOAs.  Wideband DM flags, correlated-noise
realizations and ``calculate_random_models`` are not ported yet.
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.toa import TOA, TOAs

__all__ = ["zero_residuals", "make_fake_toas_uniform",
           "make_fake_toas_fromMJDs"]


def _as_rng(rng, default_seed=0):
    """None -> default_rng(default_seed), int -> default_rng(int),
    a Generator passes through."""
    if rng is None:
        return np.random.default_rng(default_seed)
    if isinstance(rng, (int, np.integer)):
        return np.random.default_rng(int(rng))
    return rng


def zero_residuals(toas: TOAs, model, iterations=2, device=None):
    """Shift TOA ticks so model residuals vanish (phase inversion by
    Newton iteration; two passes reach sub-ns)."""
    for _ in range(iterations):
        # nearest tracking pinned: fake TOAs carry no -pn flags, and a
        # TRACK -2 par must still simulate (as pint_tpu pins it)
        r = Residuals(toas, model, device=device, subtract_mean=False,
                      track_mode="nearest")
        resid_sec = r.time_resids
        toas.ticks = toas.ticks - np.round(resid_sec * 2**32).astype(np.int64)
        toas._compute_posvels()
    return toas


def make_fake_toas_uniform(start_mjd, end_mjd, ntoas, model,
                           freq_mhz=1400.0, obs="@", error_us=1.0,
                           add_noise=False, rng=None, flags=None,
                           fuzz_days=0.0, multifreq=False, device=None):
    """Evenly spaced TOAs with zero residuals under ``model`` (+ white
    noise scaled by the TOA errors with ``add_noise``).  ``flags`` is
    one flag dict for every TOA, or a per-TOA list; ``fuzz_days``
    jitters the spacing; ``multifreq=True`` emits one TOA per frequency
    at every epoch."""
    mjds = np.linspace(float(start_mjd), float(end_mjd), int(ntoas))
    if fuzz_days:
        rng = _as_rng(rng)
        fuzz = rng.normal(0.0, float(fuzz_days), int(ntoas))
        mjds = np.sort(np.clip(mjds + fuzz, float(start_mjd),
                               float(end_mjd)))
    if multifreq:
        nf = np.atleast_1d(np.asarray(freq_mhz, np.float64)).size
        mjds = np.repeat(mjds, nf)
        freq_mhz = np.tile(np.atleast_1d(np.asarray(freq_mhz)), int(ntoas))
    return make_fake_toas_fromMJDs(
        mjds, model, freq_mhz=freq_mhz, obs=obs, error_us=error_us,
        add_noise=add_noise, rng=rng, flags=flags, device=device)


def make_fake_toas_fromMJDs(mjds, model, freq_mhz=1400.0, obs="@",
                            error_us=1.0, add_noise=False, rng=None,
                            flags=None, device=None):
    """Zero-residual TOAs at explicit MJDs."""
    mjds = np.asarray(mjds, dtype=np.float64)
    ntoas = len(mjds)
    freqs = np.broadcast_to(np.asarray(freq_mhz, dtype=np.float64), (ntoas,))
    if isinstance(flags, (list, tuple)):
        if len(flags) != ntoas:
            raise ValueError(
                f"per-TOA flags list has {len(flags)} entries for "
                f"{ntoas} TOAs")
        flag_list = [dict(f or {}) for f in flags]
    else:
        flag_list = [dict(flags or {}) for _ in range(ntoas)]
    toa_list = []
    for mjd, f, fl in zip(mjds, freqs, flag_list):
        day = int(np.floor(mjd))
        num = int(round((mjd - day) * 10**12))
        toa_list.append(TOA(day, num, 10**12, float(error_us), float(f),
                            obs, fl, "fake"))
    toas = TOAs(toa_list, ephem=model.meta.get("EPHEM", "builtin"),
                planets=False)
    zero_residuals(toas, model, device=device)
    if add_noise:
        rng = _as_rng(rng)
        noise = rng.standard_normal(len(toas)) * toas.error_us * 1e-6
        toas.ticks = toas.ticks + np.round(noise * 2**32).astype(np.int64)
        toas._compute_posvels()
    return toas
