"""Observatory registry and site geometry.

Counterpart of the reference's observatory layer (reference:
src/pint/observatory/__init__.py:149-560, topo_obs.py) redesigned for the
host-ingest role: observatories resolve names/aliases/tempo codes, supply
clock-correction chains, and produce SSB posvels for TOA epochs.

Site coordinates are embedded (public ITRF values, same data the reference
ships in observatories.json).
"""

from __future__ import annotations

import warnings

import numpy as np

from pint_tpu_torch import C_M_PER_S
from pint_tpu_torch.ephem import PosVel, get_ephemeris
from pint_tpu_torch.obs.erot import gcrs_posvel_from_itrf


class Observatory:
    """Base observatory: named, alias-resolvable, clock-correctable."""

    _registry: dict = {}

    def __init__(self, name, aliases=(), tempo_code=None, itoa_code=None):
        self.name = name.lower()
        self.aliases = tuple(a.lower() for a in aliases)
        self.tempo_code = tempo_code
        self.itoa_code = itoa_code
        # a later site takes over an alias or code of an earlier one, but
        # never a key that is another observatory's primary name
        Observatory._registry[self.name] = self
        for key in self.aliases + tuple(
            c.lower() for c in (tempo_code, itoa_code) if c
        ):
            holder = Observatory._registry.get(key)
            if holder is None or holder.name != key:
                Observatory._registry[key] = self

    # -- geometry ------------------------------------------------------------
    def posvel_ssb(self, ticks, ephem="builtin") -> PosVel:
        """Observatory posvel wrt SSB [ls, ls/s] at TDB ticks."""
        raise NotImplementedError

    def earth_location_itrf(self):
        return None

    #: True if TOAs from this site are already barycentric TDB
    is_barycenter = False

    # -- clock ---------------------------------------------------------------
    def clock_corrections_sec(self, utc_mjd_float):
        """Observatory->UTC clock corrections [s] (host ingest).

        Default: no clock chain (warn once).  TopoObs looks for clock
        files; see pint_tpu_torch.obs.clock.
        """
        return np.zeros_like(np.asarray(utc_mjd_float, dtype=np.float64))


class TopoObs(Observatory):
    """Ground observatory at fixed ITRF coordinates."""

    def __init__(self, name, itrf_xyz, clock_files=(), **kw):
        super().__init__(name, **kw)
        self.itrf_xyz = np.asarray(itrf_xyz, dtype=np.float64)
        self.clock_files = tuple(clock_files)
        self._clock_chain = None
        self._warned_noclock = False

    def posvel_gcrs(self, ticks) -> PosVel:
        return gcrs_posvel_from_itrf(self.itrf_xyz, ticks)

    def posvel_ssb(self, ticks, ephem="builtin") -> PosVel:
        from pint_tpu_torch.ephem import body_posvel_ssb

        earth = body_posvel_ssb("earth", ticks, ephem)
        site = self.posvel_gcrs(ticks)
        return PosVel(earth.pos + site.pos, earth.vel + site.vel)

    def clock_corrections_sec(self, utc_mjd_float):
        from pint_tpu_torch.obs.clock import find_clock_chain

        if self._clock_chain is None:
            self._clock_chain = find_clock_chain(self)
        mjd = np.asarray(utc_mjd_float, dtype=np.float64)
        if not self._clock_chain:
            if not self._warned_noclock:
                warnings.warn(
                    f"no clock files found for observatory '{self.name}' "
                    "(searched $PINT_TORCH_CLOCK_DIR and ./clock); assuming "
                    "perfect site clock (corrections ~ 0.1-1 us are being "
                    "dropped)"
                )
                self._warned_noclock = True
            return np.zeros_like(mjd)
        out = np.zeros_like(mjd)
        for cf in self._clock_chain:
            out += cf.evaluate_sec(mjd)
        return out


class BarycenterObs(Observatory):
    """TOAs already at the SSB in TDB ('@' / 'bat'); geometry is a no-op.
    (reference: special_locations.py:71)"""

    is_barycenter = True

    def posvel_ssb(self, ticks, ephem="builtin") -> PosVel:
        ticks = np.atleast_1d(ticks)
        z = np.zeros(ticks.shape + (3,))
        return PosVel(z, z.copy())


class GeocenterObs(Observatory):
    """TOAs referenced to the geocenter (reference: special_locations.py:117)."""

    def posvel_ssb(self, ticks, ephem="builtin") -> PosVel:
        from pint_tpu_torch.ephem import body_posvel_ssb

        return body_posvel_ssb("earth", ticks, ephem)


def get_observatory(name) -> Observatory:
    """Resolve an observatory by name / alias / tempo code / ITOA code."""
    _ensure_builtin()
    key = str(name).strip().lower()
    obs = Observatory._registry.get(key)
    if obs is None:
        raise KeyError(
            f"unknown observatory {name!r}; known: "
            + ", ".join(sorted(k for k, v in Observatory._registry.items()
                               if k == v.name))
        )
    return obs


# --- builtin site table -----------------------------------------------------
# ITRF XYZ in meters (public geodetic data; values as the pulsar-timing
# community uses them, cf. reference observatories.json) + tempo one-char
# codes and two-char ITOA codes.

_BUILTIN_SITES = {
    "gbt": ([882589.289, -4924872.368, 3943729.418], "1", "GB", ()),
    # fake telescope for the IPTA data challenge (reference
    # observatories.json "AXIS", imported from TEMPO2 observatories.dat)
    "axis": ([6378138.0, 0.0, 0.0], None, None, ("axi",)),
    "quabbin": ([1430913.350, -4495711.384, 4278113.975], "2", "QU", ()),
    "arecibo": ([2390487.080, -5564731.357, 1994720.633], "3", "AO", ("aoutc",)),
    "hobart": ([-3950077.96, 2522377.31, -4311667.52], "4", "HO", ()),
    "princeton": ([1288748.38, -4694221.77, 4107418.80], "5", "PR", ()),
    "vla": ([-1601192.0, -5041981.4, 3554871.4], "6", "VL", ("jvla",)),
    "parkes": ([-4554231.5, 2816759.1, -3454036.3], "7", "PK", ("pks",)),
    "jodrell": ([3822625.769, -154105.255, 5086486.256], "8", "JB", ()),
    "gb300": ([881856.58, -4925311.86, 3943459.70], "9", "G3", ()),
    "gb140": ([882872.57, -4924552.73, 3944154.92], "a", "G1", ()),
    "gb853": ([882315.33, -4925191.41, 3943414.05], "b", "G8", ()),
    "most": ([-4483311.64, 2648815.92, -3671909.31], "e", "MO", ()),
    "nancay": ([4324165.81, 165927.11, 4670132.83], "f", "NC", ("ncy",)),
    "effelsberg": ([4033947.146, 486990.898, 4900431.067], "g", "EF", ("eff",)),
    "jb_mkii": ([3822846.76, -153802.28, 5086285.90], "h", "J2", ("jbmk2",)),
    "wsrt": ([3828445.659, 445223.600, 5064921.568], "i", "WS", ("we",)),
    "fast": ([-1668557.0, 5506838.0, 2744934.0], "k", "FA", ()),
    "meerkat": ([5109360.133, 2006852.586, -3238948.127], "m", "MK", ()),
    "gmrt": ([1656342.30, 5797947.77, 2073243.16], "r", "GM", ()),
    "shao": ([-2826711.951, 4679231.627, 3274665.675], "s", "SH", ()),
    "lofar": ([3826577.462, 461022.624, 5064892.526], "t", "LF", ()),
    "mwa": ([-2559454.08, 5095372.14, -2849057.18], "u", "MW", ()),
    "pico_veleta": ([5088964.0, -301689.8, 3825017.0], "v", "PV", ("pv",)),
    "lwa1": ([-1602196.60, -5042313.47, 3553971.51], "x", "LW", ()),
    "chime": ([-2059166.313, -3621302.972, 4814304.113], "y", "CH", ()),
    "srt": ([4865182.766, 791922.689, 4035137.174], "z", "SR", ()),
}

_builtin_loaded = False


def _ensure_builtin():
    global _builtin_loaded
    if _builtin_loaded:
        return
    _builtin_loaded = True
    for name, (xyz, tcode, icode, aliases) in _BUILTIN_SITES.items():
        TopoObs(name, xyz, tempo_code=tcode, itoa_code=icode, aliases=aliases)
    BarycenterObs("barycenter", aliases=("@", "bat", "ssb"))
    GeocenterObs("geocenter", aliases=("coe", "0"), itoa_code="GC")
