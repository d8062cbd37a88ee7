"""Parameter metadata and par-file value codecs (pint_tpu
models/parameter.py).

A :class:`Param` is metadata only (name, kind, units, frozen, aliases,
par-file formatting); parameter values live in the model's flat
``{name: float64}`` dict.  Canonical internal units make every value a
bare float64:

- angles -> radians          - times/epochs -> TDB seconds since J2000
- frequencies -> Hz          - DM -> pc cm^-3
- masses -> solar masses     - dimensionless as-is

Kinds:
- ``float``  : plain number (optionally with a par-file unit scale)
- ``angle``  : RA "17:48:52.75" (hourangle) or DEC "-20:21:29.0" (deg)
- ``mjd``    : epoch, parsed exactly then stored as ticks AND f64 seconds
- ``bool``   : Y/N/1/0/T/F
- ``str``    : passthrough (not fittable)
- ``prefix`` : indexed family template (F0,F1,... / GLF0_1 / DMX_0001)
- ``mask``   : value + TOA-subset selector (JUMP/EFAC/EQUAD/ECORR...)
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

import numpy as np

from pint_tpu_torch.time.mjd import mjd_string_to_day_frac, mjd_to_ticks_tdb

__all__ = ["Param", "parse_angle", "format_angle", "parse_bool",
           "mjd_value_to_ticks", "prefix_index"]


def parse_angle(s: str, hourangle: bool) -> float:
    """Par-file angle string -> radians.  Accepts sexagesimal
    (``17:48:52.75``) or plain degrees/hours as a bare float."""
    s = s.strip()
    if ":" in s:
        sign = -1.0 if s.lstrip().startswith("-") else 1.0
        parts = s.lstrip("+-").split(":")
        val = 0.0
        for i, p in enumerate(parts):
            val += abs(float(p)) / 60.0**i
        val *= sign
    else:
        val = float(s)
    scale = 15.0 if hourangle else 1.0
    return np.deg2rad(val * scale)


def format_angle(rad: float, hourangle: bool, ndigits=8) -> str:
    scale = 15.0 if hourangle else 1.0
    val = np.rad2deg(rad) / scale
    sign = "-" if val < 0 else ""
    val = abs(val)
    d = int(val)
    m = int((val - d) * 60)
    s = (val - d - m / 60.0) * 3600
    if round(s, ndigits) >= 60.0:
        s = 0.0
        m += 1
    if m >= 60:
        m = 0
        d += 1
    return f"{sign}{d:02d}:{m:02d}:{s:0{3+ndigits}.{ndigits}f}"


def parse_bool(s: str) -> bool:
    return str(s).strip().upper() in ("Y", "YES", "T", "TRUE", "1")


def mjd_value_to_ticks(s: str) -> int:
    """Par-file MJD string -> exact TDB ticks (par epochs are TDB when
    UNITS TDB, the only supported units for now)."""
    d, n, den = mjd_string_to_day_frac(str(s))
    return mjd_to_ticks_tdb(d, n, den)


_PREFIX_RE = re.compile(r"^([A-Za-z][A-Za-z0-9_]*?)_?(\d+)$")


def prefix_index(name: str):
    """Split an indexed name: 'F0' -> ('F', 0); 'DMX_0001' -> ('DMX_', 1);
    returns None if not indexed."""
    m = _PREFIX_RE.match(name)
    if not m:
        return None
    return m.group(1) + ("_" if name[len(m.group(1))] == "_" else ""), int(
        m.group(2)
    )


@dataclass
class Param:
    """Parameter metadata (values live in the model's params dict)."""

    name: str
    kind: str = "float"  # float|angle|mjd|bool|str|prefix|mask
    description: str = ""
    units: str = ""
    #: multiply par-file value by this to get internal units
    scale: float = 1.0
    #: tempo convention: a par value with |v| > scale_threshold is taken
    #: to be in units of scale_factor (e.g. "PBDOT 7.2" means 7.2e-12;
    #: reference: parameter.py:791-793)
    unit_scale: bool = False
    scale_factor: float = 1e-12
    scale_threshold: float = 1e-7
    frozen: bool = True
    fittable: bool = True
    hourangle: bool = False  # for kind=angle
    aliases: tuple = ()
    #: for mask params: selector spec, e.g. ("-fe", "L-wide") or
    #: ("mjd", 50000.0, 51000.0) or ("tel", "gbt")
    select: tuple = ()
    uncertainty: Optional[float] = None
    #: raw par-file string (kept for exact round-trip of unfit params)
    raw: Optional[str] = None

    def parse(self, s: str) -> float:
        if self.kind == "angle":
            return parse_angle(s, self.hourangle)
        if self.kind == "mjd":
            return float(mjd_value_to_ticks(s)) / 2**32  # f64 seconds
        if self.kind == "bool":
            return float(parse_bool(s))
        s2 = s.upper().replace("D", "E") if re.search(r"\dD[+-]?\d", s.upper()) else s
        v = float(s2)
        if self.unit_scale and abs(v) > self.scale_threshold:
            v *= self.scale_factor
        return v * self.scale

    def parse_uncertainty(self, s: str) -> float:
        """Par-file uncertainty token -> internal units.  Float kinds get
        the full value treatment (D exponents, tempo unit_scale keyed on
        the uncertainty's own magnitude — matching the reference, where
        floatParameter shares one codec for value and uncertainty); other
        kinds scale linearly."""
        if self.kind == "float":
            return self.parse(s)
        return float(s.upper().replace("D", "E")) * self.scale

    def format(self, value: float, ndigits=15) -> str:
        if self.kind == "angle":
            return format_angle(value, self.hourangle)
        if self.kind == "mjd":
            from pint_tpu_torch.time.mjd import ticks_to_mjd_string_tdb

            return ticks_to_mjd_string_tdb(int(round(value * 2**32)), 12)
        if self.kind == "bool":
            return "Y" if value else "N"
        if self.scale != 1.0:
            # float() first: repr of a numpy-2 scalar is
            # 'np.float64(...)', which no par parser reads back
            return repr(float(value) / self.scale)
        if ndigits >= 15:
            # shortest round-trip repr: %.15g drops the last 1-2
            # significant bits (an F0 would come back changed after
            # as_parfile -> get_model; caught by the fuzz harness)
            return repr(float(value))
        return f"{value:.{ndigits}g}"
