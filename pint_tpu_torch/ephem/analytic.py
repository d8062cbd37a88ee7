"""Built-in analytic solar-system ephemeris (no data files).

Keplerian propagation from the Standish (JPL) approximate mean elements,
valid 1800-2050 AD (public table), heliocentric ecliptic-J2000; the Sun's
own motion about the SSB is recovered from the mass-weighted planet sum;
the Earth is offset from the EMB by a truncated Meeus-style lunar series.

Accuracy (vs DE):  EMB ~1e-5 AU (planetary perturbations are not modeled),
Earth/EMB offset ~10 km, outer planets ~1e-4 AU.  In Roemer-delay terms
that is ~10 ms absolute — fine for self-consistent simulate->fit work and
geometry-insensitive paths (Shapiro, solar-wind angles), NOT for absolute
timing against real data.

All angles in radians internally; positions returned in light-seconds,
ICRS-equatorial axes (rotated from ecliptic by the J2000 obliquity).
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch import AU_LS, OBLIQUITY_J2000_ARCSEC
from pint_tpu_torch.ephem import Ephemeris, PosVel

_DEG = np.pi / 180.0

# Standish approximate elements (1800-2050): a[AU], e, i[deg], L[deg],
# varpi[deg], Omega[deg] + per-julian-century rates.  Public JPL table.
_ELEMENTS = {
    "mercury": (
        (0.38709927, 0.20563593, 7.00497902, 252.25032350, 77.45779628, 48.33076593),
        (0.00000037, 0.00001906, -0.00594749, 149472.67411175, 0.16047689, -0.12534081),
    ),
    "venus": (
        (0.72333566, 0.00677672, 3.39467605, 181.97909950, 131.60246718, 76.67984255),
        (0.00000390, -0.00004107, -0.00078890, 58517.81538729, 0.00268329, -0.27769418),
    ),
    "emb": (
        (1.00000261, 0.01671123, -0.00001531, 100.46457166, 102.93768193, 0.0),
        (0.00000562, -0.00004392, -0.01294668, 35999.37244981, 0.32327364, 0.0),
    ),
    "mars": (
        (1.52371034, 0.09339410, 1.84969142, -4.55343205, -23.94362959, 49.55953891),
        (0.00001847, 0.00007882, -0.00813131, 19140.30268499, 0.44441088, -0.29257343),
    ),
    "jupiter": (
        (5.20288700, 0.04838624, 1.30439695, 34.39644051, 14.72847983, 100.47390909),
        (-0.00011607, -0.00013253, -0.00183714, 3034.74612775, 0.21252668, 0.20469106),
    ),
    "saturn": (
        (9.53667594, 0.05386179, 2.48599187, 49.95424423, 92.59887831, 113.66242448),
        (-0.00125060, -0.00050991, 0.00193609, 1222.49362201, -0.41897216, -0.28867794),
    ),
    "uranus": (
        (19.18916464, 0.04725744, 0.77263783, 313.23810451, 170.95427630, 74.01692503),
        (-0.00196176, -0.00004397, -0.00242939, 428.48202785, 0.40805281, 0.04240589),
    ),
    "neptune": (
        (30.06992276, 0.00859048, 1.77004347, -55.12002969, 44.96476227, 131.78422574),
        (0.00026291, 0.00005105, 0.00035372, 218.45945325, -0.32241464, -0.06027121),
    ),
}

# 1 / (mass in solar masses); IAU values.
_INV_MASS = {
    "mercury": 6023600.0,
    "venus": 408523.71,
    "emb": 328900.56,
    "mars": 3098708.0,
    "jupiter": 1047.3486,
    "saturn": 3497.898,
    "uranus": 22902.98,
    "neptune": 19412.24,
}

_EARTH_MOON_MASS_RATIO = 81.30056  # M_earth / M_moon


def _kepler_E(M, e, iters=10):
    """Solve Kepler's equation E - e sin E = M (Newton, fixed iterations)."""
    E = M + e * np.sin(M)
    for _ in range(iters):
        E = E - (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
    return E


def _helio_ecliptic_au(body, T):
    """Heliocentric ecliptic-J2000 position [AU] for julian centuries T."""
    el0, el1 = _ELEMENTS[body]
    a = el0[0] + el1[0] * T
    e = el0[1] + el1[1] * T
    inc = (el0[2] + el1[2] * T) * _DEG
    L = (el0[3] + el1[3] * T) * _DEG
    varpi = (el0[4] + el1[4] * T) * _DEG
    Om = (el0[5] + el1[5] * T) * _DEG

    M = np.mod(L - varpi + np.pi, 2 * np.pi) - np.pi
    w = varpi - Om
    E = _kepler_E(M, e)
    xp = a * (np.cos(E) - e)
    yp = a * np.sqrt(1.0 - e * e) * np.sin(E)

    cw, sw = np.cos(w), np.sin(w)
    cO, sO = np.cos(Om), np.sin(Om)
    ci, si = np.cos(inc), np.sin(inc)
    x = (cw * cO - sw * sO * ci) * xp + (-sw * cO - cw * sO * ci) * yp
    y = (cw * sO + sw * cO * ci) * xp + (-sw * sO + cw * cO * ci) * yp
    z = (sw * si) * xp + (cw * si) * yp
    return np.stack([x, y, z], axis=-1)


#: Meeus ch. 47 main-problem series (ELP-2000/82 truncation), terms
#: with |longitude| >= ~0.003 deg / |distance| >= ~8 km / |latitude| >=
#: ~0.004 deg.  Columns: (D, Ms, Mp, F, lon_deg, r_km) and
#: (D, Ms, Mp, F, lat_deg).  Terms with Ms get the eccentricity factor
#: E**|Ms|.  Published physical tabulation (same status as the Niell /
#: Standish tables elsewhere in the tree).
_MOON_LR = np.array([
    (0, 0, 1, 0, 6.288774, -20905.355),
    (2, 0, -1, 0, 1.274027, -3699.111),
    (2, 0, 0, 0, 0.658314, -2955.968),
    (0, 0, 2, 0, 0.213618, -569.925),
    (0, 1, 0, 0, -0.185116, 48.888),
    (0, 0, 0, 2, -0.114332, -3.149),
    (2, 0, -2, 0, 0.058793, 246.158),
    (2, -1, -1, 0, 0.057066, -152.138),
    (2, 0, 1, 0, 0.053322, -170.733),
    (2, -1, 0, 0, 0.045758, -204.586),
    (0, 1, -1, 0, -0.040923, -129.620),
    (1, 0, 0, 0, -0.034720, 108.743),
    (0, 1, 1, 0, -0.030383, 104.755),
    (2, 0, 0, -2, 0.015327, 10.321),
    (0, 0, 1, 2, -0.012528, 0.0),
    (0, 0, 1, -2, 0.010980, 79.661),
    (4, 0, -1, 0, 0.010675, -34.782),
    (0, 0, 3, 0, 0.010034, -23.210),
    (4, 0, -2, 0, 0.008548, -21.636),
    (2, 1, -1, 0, -0.007888, 24.208),
    (2, 1, 0, 0, -0.006766, 30.824),
    (1, 0, -1, 0, -0.005163, -8.379),
    (1, 1, 0, 0, 0.004987, -16.675),
    (2, -1, 1, 0, 0.004036, -12.831),
    (2, 0, 2, 0, 0.003994, -10.445),
    (4, 0, 0, 0, 0.003861, -11.650),
    (2, 0, -3, 0, 0.003665, 14.403),
    (0, 1, -2, 0, -0.002689, -7.003),
    (2, 0, -1, 2, -0.002602, 0.0),
    (2, -1, -2, 0, 0.002390, 10.056),
    (1, 0, 1, 0, -0.002348, 6.322),
    (2, -2, 0, 0, 0.002236, -9.884),
])

_MOON_B = np.array([
    (0, 0, 0, 1, 5.128122),
    (0, 0, 1, 1, 0.280602),
    (0, 0, 1, -1, 0.277693),
    (2, 0, 0, -1, 0.173237),
    (2, 0, -1, 1, 0.055413),
    (2, 0, -1, -1, 0.046271),
    (2, 0, 0, 1, 0.032573),
    (0, 0, 2, 1, 0.017198),
    (2, 0, 1, -1, 0.009266),
    (0, 0, 2, -1, 0.008822),
    (2, -1, 0, -1, 0.008216),
    (2, 0, -2, -1, 0.004324),
    (2, 0, 1, 1, 0.004200),
])


def _moon_geocentric_au(T):
    """Geocentric ecliptic-of-date lunar position [AU], Meeus ch. 47
    truncation of ELP-2000/82 (~0.003 deg / ~10 km; enters only via the
    4670-km EMB->Earth offset, so this bounds that term at ~2-4 km,
    sub-10-us of Roemer delay).  T is julian centuries TDB."""
    T = np.asarray(T, dtype=np.float64)
    # mean arguments with the full T-polynomials (Meeus 47.1-47.5)
    Lp = (218.3164477 + 481267.88123421 * T - 0.0015786 * T**2
          + T**3 / 538841.0 - T**4 / 65194000.0) * _DEG
    D = (297.8501921 + 445267.1114034 * T - 0.0018819 * T**2
         + T**3 / 545868.0 - T**4 / 113065000.0) * _DEG
    Mp = (134.9633964 + 477198.8675055 * T + 0.0087414 * T**2
          + T**3 / 69699.0 - T**4 / 14712000.0) * _DEG
    Ms = (357.5291092 + 35999.0502909 * T - 0.0001536 * T**2
          + T**3 / 24490000.0) * _DEG
    F = (93.2720950 + 483202.0175233 * T - 0.0036539 * T**2
         - T**3 / 3526000.0 + T**4 / 863310000.0) * _DEG
    # eccentricity-of-Earth factor for solar-anomaly terms (47.6)
    E = 1.0 - 0.002516 * T - 0.0000074 * T**2

    shape = T.shape
    lon = np.zeros(shape)
    r_km = np.full(shape, 385000.56)
    for cD, cMs, cMp, cF, sl, cr in _MOON_LR:
        arg = cD * D + cMs * Ms + cMp * Mp + cF * F
        ef = E ** abs(cMs)
        lon = lon + sl * ef * np.sin(arg)
        r_km = r_km + cr * ef * np.cos(arg)
    lat = np.zeros(shape)
    for cD, cMs, cMp, cF, sb in _MOON_B:
        arg = cD * D + cMs * Ms + cMp * Mp + cF * F
        lat = lat + sb * E ** abs(cMs) * np.sin(arg)
    # planetary additives (Venus A1, Jupiter A2, A3; Meeus p. 338)
    A1 = (119.75 + 131.849 * T) * _DEG
    A2 = (53.09 + 479264.290 * T) * _DEG
    A3 = (313.45 + 481266.484 * T) * _DEG
    lon = lon + (0.003958 * np.sin(A1)
                 + 0.001962 * np.sin(Lp - F)
                 + 0.000318 * np.sin(A2))
    lat = lat + (-0.002235 * np.sin(Lp)
                 + 0.000382 * np.sin(A3)
                 + 0.000175 * np.sin(A1 - F)
                 + 0.000175 * np.sin(A1 + F)
                 + 0.000127 * np.sin(Lp - Mp)
                 - 0.000115 * np.sin(Lp + Mp))

    lon = Lp + lon * _DEG
    lat = lat * _DEG
    # Meeus arguments are mean-equinox-OF-DATE; reduce longitude to the
    # J2000 ecliptic frame the rest of the chain uses (general
    # precession p = 5029.0966"/cy; at T=0.15 the 0.2 deg of-date
    # offset rotates the 4670-km EMB->Earth arm by ~17 km ~ 57 us of
    # Roemer delay — the dominant pre-round-4 monthly error term).
    # Ecliptic-pole motion (~47"/cy) moves latitude by < 0.1 km: ignored.
    lon = lon - (5029.0966 * T + 1.11113 * T**2
                 - 0.000006 * T**3) / 3600.0 * _DEG
    r_au = r_km / 149597870.7
    cl, sl = np.cos(lon), np.sin(lon)
    cb, sb = np.cos(lat), np.sin(lat)
    return np.stack([r_au * cb * cl, r_au * cb * sl, r_au * sb], axis=-1)


_ECL = OBLIQUITY_J2000_ARCSEC / 3600.0 * _DEG
_MEAN_EQ_J2000 = np.array(
    [
        [1.0, 0.0, 0.0],
        [0.0, np.cos(_ECL), -np.sin(_ECL)],
        [0.0, np.sin(_ECL), np.cos(_ECL)],
    ]
)


def _rot(axis, angle_rad):
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    if axis == 1:
        return np.array([[1, 0, 0], [0, c, s], [0, -s, c]], dtype=float)
    if axis == 2:
        return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], dtype=float)
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], dtype=float)


# IAU 2006 frame bias (xi0 = -0.0166170", eta0 = -0.0068192",
# dalpha0 = -0.01460"): B = R1(-eta0) R2(xi0) R3(dalpha0) takes ICRS
# vectors to the mean equator/equinox of J2000 (SOFA bp00 'rb'); we
# need the opposite direction (mean-J2000 -> ICRS), i.e. B^T.  DE
# ephemerides and tempo2 work in ICRS; without this ~17 mas rotation
# Earth's position is off by up to ~8e-8 AU (~40 us of Roemer delay).
_MAS = _DEG / 3600.0e3
_FRAME_BIAS_ICRS_TO_J2000 = (
    _rot(1, -(-6.8192 * _MAS))
    @ _rot(2, (-16.6170 * _MAS))
    @ _rot(3, (-14.60 * _MAS))
)

#: ecliptic-J2000 -> ICRS (equatorial) rotation used by every built-in
#: ephemeris backend
_ECL_TO_EQ = _FRAME_BIAS_ICRS_TO_J2000.T @ _MEAN_EQ_J2000


class AnalyticEphemeris(Ephemeris):
    name = "builtin"

    def __init__(self):
        # memo of recent time arrays -> all-body positions; callers ask for
        # several bodies at identical epochs (earth, sun, planets for
        # Shapiro), and velocities need t-h/t/t+h — without this every
        # body costs 3 full solar-system sweeps.
        self._memo: dict = {}
        self._memo_order: list = []

    def _positions_cached(self, tdb_sec):
        key = (tdb_sec.shape, tdb_sec.tobytes())
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        out = self._positions_au(tdb_sec)
        self._memo[key] = out
        self._memo_order.append(key)
        if len(self._memo_order) > 8:
            self._memo.pop(self._memo_order.pop(0), None)
        return out

    def _positions_au(self, tdb_sec):
        """dict of body -> SSB ecliptic positions [AU] at tdb_sec (arr)."""
        T = np.asarray(tdb_sec, dtype=np.float64) / (86400.0 * 36525.0)
        helio = {b: _helio_ecliptic_au(b, T) for b in _ELEMENTS}
        # SSB offset: sum m_b r_b / M_total (heliocentric)
        masses = {b: 1.0 / _INV_MASS[b] for b in _ELEMENTS}
        mtot = 1.0 + sum(masses.values())
        ssb_from_sun = sum(masses[b] * helio[b] for b in _ELEMENTS) / mtot
        out = {"sun": -ssb_from_sun}
        for b in _ELEMENTS:
            out[b] = helio[b] - ssb_from_sun
        moon_geo = _moon_geocentric_au(T)
        # EMB = Earth + m_moon/(m_e+m_moon) * r_moon_geo
        f = 1.0 / (1.0 + _EARTH_MOON_MASS_RATIO)
        out["earth"] = out["emb"] - f * moon_geo
        out["moon"] = out["earth"] + moon_geo
        return out

    def posvel_ssb(self, body, tdb_sec_j2000):
        body = body.lower()
        t = np.asarray(tdb_sec_j2000, dtype=np.float64)
        # velocity by central difference (30 s step): error ~ a*h^2/6
        # ~1e-13 AU/s^2 * 150 -> far below the mean-element model error
        h = 30.0
        p0 = self._positions_cached(t)[body]
        pm = self._positions_cached(t - h)[body]
        pp = self._positions_cached(t + h)[body]
        pos = p0 @ _ECL_TO_EQ.T * AU_LS
        vel = (pp - pm) @ _ECL_TO_EQ.T * (AU_LS / (2.0 * h))
        return PosVel(pos, vel)
