"""Earth rotation: ITRF -> GCRS, owned natively (replaces erfa).

The reference delegates ITRF->GCRS to erfa's IAU2000B machinery
(reference: src/pint/erfautils.py:1-85 ``gcrs_posvel_from_itrf``).  Here the
equinox-based rotation is implemented directly:

    r_GCRS = P(t) . N(t) . R3(-GAST) . r_ITRF

- ERA/GMST: IAU 2000/2006 expressions (exact coefficients, public).
- Precession: IAU 2006 zeta_A/z_A/theta_A polynomials (Capitaine et al.).
- Nutation: leading IAU 2000 terms (9 largest; truncation ~ few mas,
  i.e. centimeters of site position — far below other builtin-path terms).
- Polar motion + UT1-UTC: read from standard IERS products installed in
  $PINT_TORCH_IERS_DIR (pint_tpu/obs/iers.py): W(xp, yp) is applied ahead
  of R3(-GAST) and UT1 = UTC + dUT1 feeds the rotation angle.  With no
  data installed both are zero (~10 m of site position ~ 30 ns Roemer
  worst case from polar motion; |UT1-UTC| < 0.9 s -> up to ~420 m
  east-west ~ 1.4 us), documented in ACCURACY.md.  For simulate->fit
  self-consistency the zero-EOP path cancels exactly.

Host-side numpy (ingest path, runs once per dataset).
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch import C_M_PER_S
from pint_tpu_torch.time.scales import TT_MINUS_TAI, tai_minus_utc, tdb_minus_tt_seconds

_AS = np.pi / (180.0 * 3600.0)  # arcsec -> rad
_TURN = 2.0 * np.pi

#: Earth rotation rate factor (revolutions per UT1 day)
_ERA_RATE = 1.00273781191135448


def _julian_centuries_tt(tdb_sec):
    """TT julian centuries since J2000 from TDB seconds (TDB~TT to <2 ms,
    irrelevant for angles varying over centuries)."""
    return np.asarray(tdb_sec, np.float64) / (86400.0 * 36525.0)


def era_radians(ut1_jd_frac_days):
    """Earth rotation angle for UT1 days since J2000 (JD - 2451545.0)."""
    d = np.asarray(ut1_jd_frac_days, np.float64)
    f = d - np.floor(d)
    return _TURN * np.mod(0.7790572732640 + f + _ERA_RATE * np.floor(d)
                          + (_ERA_RATE - 1.0) * f, 1.0)


def _delaunay(T):
    """Fundamental lunisolar arguments [rad] (IERS 2003 linear terms)."""
    deg = np.pi / 180.0
    l = (134.96340251 + 477198.86756050 * T) * deg
    lp = (357.52910918 + 35999.05029094 * T) * deg
    F = (93.27209062 + 483202.01745772 * T) * deg
    D = (297.85019547 + 445267.11151675 * T) * deg
    Om = (125.04455501 - 1934.13626197 * T) * deg
    return l, lp, F, D, Om


# Leading IAU 2000 nutation terms: multipliers (l, l', F, D, Om) and
# in-phase amplitudes (dpsi_sin, deps_cos) in arcsec.
_NUT_TERMS = [
    ((0, 0, 0, 0, 1), -17.2064161, 9.2052331),
    ((0, 0, 2, -2, 2), -1.3170906, 0.5730336),
    ((0, 0, 2, 0, 2), -0.2276413, 0.0978459),
    ((0, 0, 0, 0, 2), 0.2074554, -0.0897492),
    ((0, 1, 0, 0, 0), 0.1475877, 0.0073871),
    ((0, 1, 2, -2, 2), -0.0516821, 0.0224386),
    ((1, 0, 0, 0, 0), 0.0711159, -0.0006750),
    ((0, 0, 2, 0, 1), -0.0387298, 0.0200728),
    ((1, 0, 2, 0, 2), -0.0301461, 0.0129025),
]


def nutation_angles(T):
    """(dpsi, deps) [rad] from the truncated IAU 2000 series."""
    args = _delaunay(T)
    dpsi = np.zeros_like(np.asarray(T, np.float64))
    deps = np.zeros_like(dpsi)
    for mults, a_psi, a_eps in _NUT_TERMS:
        arg = sum(m * a for m, a in zip(mults, args) if m != 0)
        dpsi = dpsi + a_psi * np.sin(arg)
        deps = deps + a_eps * np.cos(arg)
    return dpsi * _AS, deps * _AS


def mean_obliquity(T):
    """IAU 2006 mean obliquity [rad]."""
    return (84381.406 - 46.836769 * T - 0.0001831 * T * T) * _AS


def _R1(a):
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack(
        [np.stack([o, z, z], -1), np.stack([z, c, s], -1), np.stack([z, -s, c], -1)],
        axis=-2,
    )


def _R3(a):
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack(
        [np.stack([c, s, z], -1), np.stack([-s, c, z], -1), np.stack([z, z, o], -1)],
        axis=-2,
    )


def _R2(a):
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack(
        [np.stack([c, z, -s], -1), np.stack([z, o, z], -1), np.stack([s, z, c], -1)],
        axis=-2,
    )


def precession_matrix(T):
    """IAU 2006 equatorial precession, mapping mean-of-date -> GCRS (J2000):
    P = R3(zetaA) R2(-thetaA) R3(zA)  (inverse of the Lieske date<-J2000
    composition R3(-zA) R2(thetaA) R3(-zetaA)).

    Orientation check (tested): the true pole of date mapped to J2000
    coordinates moves toward the vernal equinox, X ~ +2004.19" T.
    """
    zeta = (2.650545 + 2306.083227 * T + 0.2988499 * T**2 + 0.01801828 * T**3) * _AS
    z = (-2.650545 + 2306.077181 * T + 1.0927348 * T**2 + 0.01826837 * T**3) * _AS
    theta = (2004.191903 * T - 0.4294934 * T**2 - 0.04182264 * T**3) * _AS
    return _R3(zeta) @ _R2(-theta) @ _R3(z)


def nutation_matrix(T):
    """Nutation, mapping true-of-date -> mean-of-date:
    N = R1(-eps) R3(dpsi) R1(eps + deps)."""
    dpsi, deps = nutation_angles(T)
    eps = mean_obliquity(T)
    return _R1(-eps) @ _R3(dpsi) @ _R1(eps + deps)


def gast_radians(T, ut1_jd_frac_days):
    """Greenwich apparent sidereal time (equinox-based, IAU 2006)."""
    era = era_radians(ut1_jd_frac_days)
    # equation of the origins complement: GMST - ERA polynomial [arcsec]
    gmst_minus_era = (
        0.014506 + 4612.156534 * T + 1.3915817 * T**2 - 0.00000044 * T**3
    ) * _AS
    dpsi, _ = nutation_angles(T)
    eqeq = dpsi * np.cos(mean_obliquity(T))
    return era + gmst_minus_era + eqeq


def _utc_days_from_ticks(ticks):
    """UTC days since J2000 from TDB ticks."""
    tdb_sec = np.asarray(ticks, np.float64) / 2**32
    # invert TDB -> TT -> TAI -> UTC; iterate leap lookup once via day guess
    tt_sec = tdb_sec - tdb_minus_tt_seconds(tdb_sec)
    day_guess = np.floor(tt_sec / 86400.0 + 51544.5).astype(np.int64)
    utc_sec = tt_sec - TT_MINUS_TAI - tai_minus_utc(day_guess)
    # the TT-based day guess is ~69 s ahead of UTC: within the last
    # minute of a day preceding a leap-second insertion it lands on the
    # wrong day; one refinement with the UTC-based day settles it
    day = np.floor(utc_sec / 86400.0 + 51544.5).astype(np.int64)
    utc_sec = tt_sec - TT_MINUS_TAI - tai_minus_utc(day)
    return utc_sec / 86400.0


def polar_motion_matrix(xp_as, yp_as, T):
    """W = R3(-s') R2(xp) R1(yp): ITRF -> terrestrial intermediate frame
    (IERS 2010 conventions eq. 5.3).  Orientation check (tested): the
    ITRF pole (0,0,1) maps to ~(-xp, +yp, 1) in the intermediate frame,
    i.e. the CIP sits at (+xp, -yp) in ITRF coordinates."""
    sp = -0.000047 * T * _AS  # TIO locator s' (-47 uas/century)
    return _R3(-sp) @ _R2(np.asarray(xp_as, np.float64) * _AS) @ _R1(
        np.asarray(yp_as, np.float64) * _AS
    )


def gcrs_posvel_from_itrf(itrf_xyz_m, ticks):
    """Observatory GCRS posvel [light-seconds, ls/s] at TDB ticks.

    itrf_xyz_m: (3,) ITRF coordinates in meters; ticks: (...,) int64.
    """
    from pint_tpu_torch.ephem import PosVel
    from pint_tpu_torch.obs.iers import get_eop

    ticks = np.atleast_1d(np.asarray(ticks))
    T = _julian_centuries_tt(ticks.astype(np.float64) / 2**32)
    utc_d = _utc_days_from_ticks(ticks)

    r = np.asarray(itrf_xyz_m, np.float64) / C_M_PER_S  # light-seconds
    eop = get_eop()
    if eop is not None:
        xp, yp, dut1 = eop.at(utc_d + 51544.5)
        W = polar_motion_matrix(xp, yp, T)
        rw = np.einsum("...ij,j->...i", W, r)
        r0, r1, r2 = rw[..., 0], rw[..., 1], rw[..., 2]
        ut1_d = utc_d + dut1 / 86400.0
    else:
        r0, r1, r2 = r[0], r[1], r[2]
        ut1_d = utc_d

    gast = gast_radians(T, ut1_d)
    PN = precession_matrix(T) @ nutation_matrix(T)
    cg, sg = np.cos(gast), np.sin(gast)
    # R3(-GAST) r
    rot = np.stack(
        [cg * r0 - sg * r1, sg * r0 + cg * r1, np.broadcast_to(r2, cg.shape)],
        axis=-1,
    )
    omega = _TURN * _ERA_RATE / 86400.0  # rad/s
    vot = np.stack(
        [(-sg * r0 - cg * r1) * omega, (cg * r0 - sg * r1) * omega,
         np.zeros_like(cg)],
        axis=-1,
    )
    pos = np.einsum("...ij,...j->...i", PN, rot)
    vel = np.einsum("...ij,...j->...i", PN, vot)
    return PosVel(pos, vel)
