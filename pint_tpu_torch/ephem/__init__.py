"""Solar-system ephemerides (pint_tpu ephem/__init__.py), host-side
numpy.

- :mod:`pint_tpu_torch.ephem.compiled` is the ``builtin`` ephemeris:
  per-body Chebyshev segments read from the JAX package's
  ``pint_tpu/data/ephem_builtin.npz`` in place.
- :mod:`pint_tpu_torch.ephem.analytic` is its mean-element fallback
  (Standish elements, 1800-2050 AD; ~1e-5 AU, ~10 ms of Roemer delay:
  self-consistent, not for absolute timing of real data).

``get_ephemeris(name_or_path)`` resolves "builtin"/"analytic" or a path
or a DE name searched in $PINT_TORCH_EPHEM_DIR and ./ephemerides.  The
SPK reader is not ported: a name that resolves to a kernel file raises
``NotImplementedError``; a name that resolves to nothing falls back to
the builtin with a warning, as the JAX package does.
"""

from __future__ import annotations

import os

import numpy as np


class PosVel:
    """Position [light-seconds] and velocity [ls/s] arrays, shape (..., 3).

    A lean counterpart of the reference's utils.PosVel (utils.py:185):
    plain numpy, + and - compose frames (obj/origin bookkeeping dropped —
    callers here always work SSB-relative).
    """

    __slots__ = ("pos", "vel")

    def __init__(self, pos, vel):
        self.pos = np.asarray(pos, dtype=np.float64)
        self.vel = np.asarray(vel, dtype=np.float64)

    def __add__(self, other):
        return PosVel(self.pos + other.pos, self.vel + other.vel)

    def __sub__(self, other):
        return PosVel(self.pos - other.pos, self.vel - other.vel)

    def __neg__(self):
        return PosVel(-self.pos, -self.vel)


class Ephemeris:
    """Abstract ephemeris: body posvel wrt the solar-system barycenter."""

    name = "abstract"

    @property
    def identity(self) -> str:
        """Provenance string for cache invalidation: which concrete
        dataset actually served the positions (a requested kernel name
        can silently resolve to the builtin fallback — a prepared-TOA
        cache must notice when that changes)."""
        return type(self).__name__

    #: bodies every backend must serve
    BODIES = (
        "sun",
        "earth",
        "moon",
        "mercury",
        "venus",
        "mars",
        "jupiter",
        "saturn",
        "uranus",
        "neptune",
    )

    def posvel_ssb(self, body: str, tdb_sec_j2000) -> PosVel:
        """Body posvel wrt SSB at TDB seconds since J2000 (float64 array),
        in light-seconds / ls-per-second, ICRS-equatorial axes."""
        raise NotImplementedError


_cache: dict = {}


def get_ephemeris(name: str = "builtin") -> Ephemeris:
    key = (name or "builtin").lower()
    if key in _cache:
        return _cache[key]
    if key in ("builtin", "compiled", "none", ""):
        # _builtin memoizes per resolved data path itself (so a
        # mid-process $PINT_TORCH_EPHEM_BUILTIN switch takes effect);
        # do not double-cache under the name
        return _builtin()
    elif key == "analytic":
        from pint_tpu_torch.ephem.analytic import AnalyticEphemeris

        eph = AnalyticEphemeris()
    else:
        path = _find_kernel(name)
        if path is None:
            import warnings

            # do NOT cache the fallback under the kernel's name — a kernel
            # dropped into place later in the process must take effect
            eph = _builtin()
            detail = (
                "the builtin compiled ephemeris (see ACCURACY.md for "
                "its measured error budget)"
                if type(eph).__name__ == "CompiledEphemeris"
                else "the builtin analytic mean-element ephemeris "
                     "(~1e-5 AU, ~ms-level Roemer error)"
            )
            warnings.warn(
                f"ephemeris '{name}' not found locally; falling back to "
                f"{detail}. Place the kernel at "
                "$PINT_TORCH_EPHEM_DIR/<name>.bsp for JPL accuracy."
            )
            return eph
        raise NotImplementedError(
            f"ephemeris {name!r} resolves to the SPK kernel {path}: the "
            "SPK reader (pint_tpu/ephem/spk.py) is not ported yet "
            "(ROADMAP queue 1 item 1)")
    _cache[key] = eph
    return eph


def _builtin() -> Ephemeris:
    """The best available built-in: compiled Chebyshev (numerically
    integrated perturbations) when the data file is present, else the
    pure mean-element analytic fallback.  Memoized per resolved data
    path (the 1.4 MB npz must not be re-read on every call) while still
    honoring a mid-process $PINT_TORCH_EPHEM_BUILTIN switch."""
    from pint_tpu_torch.ephem.compiled import CompiledEphemeris, data_path

    key = ("__builtin__", data_path())
    if key in _cache:
        return _cache[key]
    try:
        eph = CompiledEphemeris()
    except (FileNotFoundError, OSError):
        from pint_tpu_torch.ephem.analytic import AnalyticEphemeris

        # NOT cached: a data file installed later must take effect
        return AnalyticEphemeris()
    _cache[key] = eph
    return eph


def _find_kernel(name: str):
    # exact path first (case preserved — filesystems are case-sensitive)
    if os.path.exists(name):
        return name
    lname = name.lower()
    candidates = []
    for d in (os.environ.get("PINT_TORCH_EPHEM_DIR"), "ephemerides", "."):
        if d:
            for n in (name, lname, name.upper()):
                candidates += [os.path.join(d, n + ".bsp"), os.path.join(d, n)]
    for c in candidates:
        if os.path.exists(c):
            return c
    return None


def body_posvel_ssb(body, ticks, ephem="builtin") -> PosVel:
    """Convenience: posvel at int64 device ticks (2^-32 s since J2000 TDB)."""
    tdb_sec = np.asarray(ticks, dtype=np.float64) / 2**32
    return get_ephemeris(ephem).posvel_ssb(body, tdb_sec)
