"""Photon-event FITS files -> TOAs (pint_tpu event_toas.py).

Counterpart of the reference event_toas module (reference:
src/pint/event_toas.py ``get_NICER_TOAs`` etc., per-mission default
uncertainties; src/pint/fermi_toas.py ``load_Fermi_TOAs`` with photon
weights), on the port's pure-numpy FITS reader
(:mod:`pint_tpu_torch.fits`).  Host work only: the TOAs reach the
device when a model is prepared on them.

Supported time systems: barycentered events (TIMESYS=TDB,
TIMEREF=SOLARSYSTEM -> observatory '@') and geocentric TT/UTC events
(-> 'geocenter' with a ``-timescale`` flag the TOA pipeline honors).
Not ported: ``orbfile=`` (spacecraft orbit files, ``obs/satellite.py``,
ROADMAP queue 1 item 1), which raises.
"""

from __future__ import annotations

import warnings

import numpy as np

from pint_tpu_torch.fits import read_events
from pint_tpu_torch.toa import TOA, TOAs

__all__ = ["load_event_TOAs", "load_fits_TOAs", "get_NICER_TOAs",
           "get_RXTE_TOAs", "get_NuSTAR_TOAs", "get_XMM_TOAs",
           "get_Swift_TOAs", "get_IXPE_TOAs", "load_Fermi_TOAs",
           "met_to_day_ns", "mjdref_from_header"]

#: per-mission default TOA uncertainty [us] (reference event_toas.py
#: mission tables)
_MISSION_ERR_US = {
    "nicer": 0.1, "rxte": 2.5, "nustar": 65.0, "xmm": 30.0,
    "swift": 300.0, "ixpe": 100.0, "fermi": 1.0,
}

#: missions whose event extension is not named EVENTS
_MISSION_EXTNAME = {"rxte": "XTE_SE"}


def _pi_to_kev(mission, pi):
    """Mission-specific PI-channel -> keV conversion (reference:
    event_toas.py per-mission tables)."""
    m = mission.lower()
    if m == "nicer":
        return pi * 0.010  # 10 eV channels
    if m == "xmm":
        return pi * 0.001  # 1 eV channels
    if m == "nustar":
        return pi * 0.040 + 1.6
    if m == "swift":
        return pi * 0.010
    raise ValueError(
        f"no PI->keV conversion known for mission {mission!r}; filter "
        "the events by energy before loading")


def mjdref_from_header(header):
    """(integer MJD, fractional day) reference epoch from an event-FITS
    header (MJDREFI/MJDREFF or combined MJDREF)."""
    if "MJDREFI" in header:
        return int(header["MJDREFI"]), float(header.get("MJDREFF", 0.0))
    ref = float(header.get("MJDREF", 0.0))
    return int(ref), ref - int(ref)


def met_to_day_ns(reff: float, t: float, timezero: float = 0.0):
    """(extra_days, ns_of_day) for MET second ``t`` past MJDREF
    fraction ``reff``, at sub-ns resolution: each addend is split into
    (integer, fractional) seconds with divmod, so no float ever holds a
    ~1e18 ns value (float64 would quantize it to ~128 ns)."""
    ref_ns = int(round(reff * 86400.0 * 1e9))
    tz_int, tz_frac = divmod(float(timezero), 1.0)
    t_int, t_frac = divmod(float(t), 1.0)
    total_ns = (
        ref_ns
        + (int(t_int) + int(tz_int)) * 10**9
        + int(round((t_frac + tz_frac) * 1e9))
    )
    return divmod(total_ns, 86400 * 10**9)


def load_event_TOAs(path, mission, weights=None, extname=None,
                    energy_range_kev=None, errors_us=None,
                    ephem="builtin", planets=False, orbfile=None):
    """Read photon events into a :class:`~pint_tpu_torch.toa.TOAs`
    (pint_tpu event_toas.py:72).

    weights: None | array | column name (e.g. Fermi 'WEIGHT'); stored as
    ``-weight`` flags for the photon-likelihood fitters.  The returned
    TOAs carry ``fits_rows``, the event table's row of each TOA kept."""
    if orbfile is not None:
        raise NotImplementedError(
            "load_event_TOAs(orbfile=): spacecraft orbit files "
            "(obs/satellite.py) are not ported (ROADMAP queue 1 item 1)")
    if extname is None:
        extname = _MISSION_EXTNAME.get(mission.lower(), "EVENTS")
    header, data = read_events(path, extname=extname)
    time = np.asarray(data["TIME"], dtype=np.float64)
    timezero = float(header.get("TIMEZERO", 0.0))
    refi, reff = mjdref_from_header(header)
    timesys = str(header.get("TIMESYS", "TT")).strip().upper()
    timeref = str(header.get("TIMEREF", "LOCAL")).strip().upper()
    if timeref in ("SOLARSYSTEM", "SSB"):
        obs, scale = "@", "tdb"
    elif timeref in ("GEOCENTRIC", "GEOCENTER"):
        obs, scale = "geocenter", timesys.lower()
    else:
        warnings.warn(
            f"event file TIMEREF={timeref!r} (spacecraft-local times); "
            "treating as geocentric — barycenter the events for absolute "
            "timing")
        obs, scale = "geocenter", timesys.lower()

    if energy_range_kev is not None:
        if "PI" not in data:
            raise KeyError("energy_range_kev needs a PI column")
        kev = _pi_to_kev(mission, np.asarray(data["PI"], np.float64))
        lo, hi = energy_range_kev
        keep = (kev >= lo) & (kev <= hi)
    else:
        keep = np.ones(len(time), dtype=bool)

    if isinstance(weights, str):
        weights = np.asarray(data[weights], dtype=np.float64)
    err_us = errors_us if errors_us is not None else \
        _MISSION_ERR_US.get(mission.lower(), 1.0)

    toa_list = []
    widx = np.flatnonzero(keep)
    for j, t in enumerate(time[keep]):
        day_extra, ns = met_to_day_ns(reff, float(t), timezero)
        flags = {"timescale": scale, "mission": mission}
        if weights is not None:
            flags["weight"] = repr(float(weights[widx[j]]))
        toa_list.append(
            TOA(refi + int(day_extra), ns, 86400 * 10**9,
                err_us, 0.0, obs, flags, mission))
    out = TOAs(toa_list, ephem=ephem, planets=planets, include_clock=False)
    out.fits_rows = widx
    return out


def load_fits_TOAs(path, mission="generic", **kw):
    return load_event_TOAs(path, mission, **kw)


def get_NICER_TOAs(path, **kw):
    return load_event_TOAs(path, "nicer", **kw)


def get_RXTE_TOAs(path, **kw):
    return load_event_TOAs(path, "rxte", **kw)


def get_NuSTAR_TOAs(path, **kw):
    return load_event_TOAs(path, "nustar", **kw)


def get_XMM_TOAs(path, **kw):
    return load_event_TOAs(path, "xmm", **kw)


def get_Swift_TOAs(path, **kw):
    return load_event_TOAs(path, "swift", **kw)


def get_IXPE_TOAs(path, **kw):
    return load_event_TOAs(path, "ixpe", **kw)


def load_Fermi_TOAs(path, weightcolumn="WEIGHT", **kw):
    """Fermi LAT photons with weights (pint_tpu event_toas.py:193).  A
    missing weight column loads unweighted photons with a warning, so a
    typo'd column name does not drop the weighting silently."""
    try:
        return load_event_TOAs(path, "fermi", weights=weightcolumn, **kw)
    except KeyError:
        warnings.warn(
            f"weight column {weightcolumn!r} not found in {path}; "
            "loading UNWEIGHTED photons")
        return load_event_TOAs(path, "fermi", **kw)
