"""Compiled built-in ephemeris: per-body Chebyshev segments.

Loads ``pint_tpu/data/ephem_builtin.npz`` produced by
tools/build_ephemeris.py (numerically integrated N-body perturbations
spliced onto published mean elements — see that module's docstring and
ACCURACY.md for the error budget).  Replaces the role of jplephem + a
downloaded DE kernel in the reference (solar_system_ephemerides.py):
same evaluation structure as a real SPK type-2 segment set — segment
lookup + Chebyshev evaluation, with exact analytic derivatives for the
velocities (the JAX package's pint_tpu/ephem/spk.py reads genuine JPL
kernels; the port does not yet).

The Earth/EMB split uses the truncated lunar series from
pint_tpu_torch.ephem.analytic (offset scale 4670 km; series error contributes
~0.1 us of Roemer delay).
"""

from __future__ import annotations

import os

import numpy as np

from pint_tpu_torch import AU_LS, DATA_DIR
from pint_tpu_torch.ephem import Ephemeris, PosVel
from pint_tpu_torch.ephem.analytic import (
    _EARTH_MOON_MASS_RATIO,
    _ECL_TO_EQ,
    _moon_geocentric_au,
)

#: the JAX package's data file, read in place
_DEFAULT_DATA_PATH = os.path.join(DATA_DIR, "ephem_builtin.npz")


def data_path() -> str:
    """Resolved at call time so $PINT_TORCH_EPHEM_BUILTIN can switch
    datasets mid-process (used by the calibration tooling)."""
    return os.environ.get("PINT_TORCH_EPHEM_BUILTIN") or _DEFAULT_DATA_PATH

_SEC_PER_DAY = 86400.0


def _cheb_eval_with_deriv(coeffs, x):
    """Clenshaw evaluation of sum c_j T_j(x) and its x-derivative.

    coeffs: (nt, 3, ncoef); x: (nt,) in [-1, 1].
    Returns (val (nt,3), dval/dx (nt,3))."""
    ncoef = coeffs.shape[-1]
    b1 = np.zeros(coeffs.shape[:-1])
    b2 = np.zeros_like(b1)
    d1 = np.zeros_like(b1)
    d2 = np.zeros_like(b1)
    x2 = (2.0 * x)[:, None]
    for j in range(ncoef - 1, 0, -1):
        b1, b2 = x2 * b1 - b2 + coeffs[..., j], b1
        d1, d2 = x2 * d1 - d2 + 2.0 * b2, d1  # d/dx of the recurrence
    val = x[:, None] * b1 - b2 + coeffs[..., 0]
    dval = b1 + x[:, None] * d1 - d2
    return val, dval


class CompiledEphemeris(Ephemeris):
    name = "builtin-compiled"

    def __init__(self, path: str | None = None):
        path = path or data_path()
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        st = os.stat(path)
        self._identity = f"compiled:{path}:{st.st_mtime_ns}:{st.st_size}"
        with np.load(path) as z:
            self.t0_day = float(z["t0_day"])
            self.t1_day = float(z["t1_day"])
            self._seg = {}
            for b in [str(x) for x in z["bodies"]]:
                self._seg[b] = (float(z[f"{b}_seg_d"]),
                                np.ascontiguousarray(z[f"{b}_coeffs"]))
            if "tdbtt_coeffs" in z:
                self._seg["tdbtt"] = (float(z["tdbtt_seg_d"]),
                                      np.ascontiguousarray(
                                          z["tdbtt_coeffs"]))

    @property
    def identity(self) -> str:
        return self._identity

    def tdb_minus_tt(self, tt_sec_j2000):
        """Numerical TDB-TT [s] from the compiled time ephemeris
        (integral of the geocentric time-dilation rate along the
        compiled orbits, (L_B, TDB0) calibrated to tempo2's IF99
        realization — see tools/build_ephemeris.build_time_ephemeris).
        Raises KeyError/ValueError when no table covers the epoch."""
        t_day = np.atleast_1d(
            np.asarray(tt_sec_j2000, np.float64)) / _SEC_PER_DAY
        val, _ = self._body_cheb("tdbtt", t_day)
        out = val[:, 0]
        if np.ndim(tt_sec_j2000) == 0:
            return float(out[0])
        return out

    def _body_cheb(self, body, t_day):
        """(pos AU, vel AU/day) in ecliptic J2000, from the segments."""
        seg_d, coeffs = self._seg[body]
        t_day = np.atleast_1d(np.asarray(t_day, np.float64))
        if (t_day < self.t0_day).any() or (t_day > self.t1_day).any():
            bad_lo = float(t_day.min())
            bad_hi = float(t_day.max())
            raise ValueError(
                f"epoch range [{bad_lo + 51544.5:.1f}, "
                f"{bad_hi + 51544.5:.1f}] MJD outside the compiled "
                f"builtin ephemeris span "
                f"[{self.t0_day + 51544.5:.1f}, "
                f"{self.t1_day + 51544.5:.1f}]; supply a JPL kernel "
                "(PINT_TORCH_EPHEM_DIR) for epochs outside it"
            )
        idx = np.minimum(
            ((t_day - self.t0_day) // seg_d).astype(np.int64),
            coeffs.shape[0] - 1,
        )
        lo = self.t0_day + idx * seg_d
        x = (t_day - lo) * (2.0 / seg_d) - 1.0
        val, dval = _cheb_eval_with_deriv(coeffs[idx], x)
        return val, dval * (2.0 / seg_d)

    def _body_bary(self, body, t_day):
        """Barycentric (pos AU, vel AU/day), ecliptic J2000.  emb and
        sun are stored barycentric; planets are stored heliocentric
        (smooth) and get the Sun's barycentric motion added back."""
        if body in ("emb", "sun"):
            return self._body_cheb(body, t_day)
        pos, vel = self._body_cheb(body, t_day)
        spos, svel = self._body_cheb("sun", t_day)
        return pos + spos, vel + svel

    def _body_ecliptic_au(self, body, tdb_sec):
        """Position only [AU, ecliptic]; used by the build self-check."""
        return self._body_bary(body, np.asarray(tdb_sec) / _SEC_PER_DAY)[0]

    def posvel_ssb(self, body, tdb_sec_j2000):
        body = body.lower()
        t_day = np.atleast_1d(
            np.asarray(tdb_sec_j2000, np.float64)) / _SEC_PER_DAY
        f = 1.0 / (1.0 + _EARTH_MOON_MASS_RATIO)
        if body in ("earth", "moon"):
            pos, vel = self._body_bary("emb", t_day)
            T = t_day / 36525.0
            h = 1.0 / 36525.0  # one-day central difference, in centuries
            moon = _moon_geocentric_au(T)
            dmoon = (_moon_geocentric_au(T + 0.5 * h)
                     - _moon_geocentric_au(T - 0.5 * h))  # per day
            if body == "earth":
                pos = pos - f * moon
                vel = vel - f * dmoon
            else:
                pos = pos + (1.0 - f) * moon
                vel = vel + (1.0 - f) * dmoon
        else:
            pos, vel = self._body_bary(body, t_day)
        pos = pos @ _ECL_TO_EQ.T * AU_LS
        vel = vel @ _ECL_TO_EQ.T * (AU_LS / _SEC_PER_DAY)
        return PosVel(pos, vel)
