"""IERS Earth-orientation parameters (polar motion, UT1-UTC).

The reference delegates EOP handling to astropy's auto-downloaded IERS
tables, consumed by erfa inside ``gcrs_posvel_from_itrf`` (reference:
src/pint/erfautils.py:1-85).  Here the table layer is owned natively:
standard IERS products dropped into ``$PINT_TORCH_IERS_DIR`` (or
``./iers``) are parsed host-side and applied in the ITRF->GCRS chain
(pint_tpu/obs/erot.py) as

    r_GCRS = P . N . R3(-GAST(UT1)) . W(xp, yp) . r_ITRF

With no data present the EOP are zero (UT1 = UTC, no polar motion) —
exactly the documented ~1.4 us (UT1) and ~30 ns (polar motion) builtin
accuracy terms in ACCURACY.md; installing a finals file removes them.

Supported formats, auto-detected by filename:

- ``finals2000A*`` / ``finals.*`` — IERS Bulletin A fixed-width
  (the standard rapid-service file): MJD in cols 8-15, PM-x in 19-27,
  PM-y in 38-46, UT1-UTC in 59-68 (1-based); rows without a UT1 value
  (far-future predictions) are dropped.
- ``eopc04*`` — IERS EOP C04 whitespace columns
  (yr mo dy MJD xp yp UT1-UTC ...), comment/header lines skipped.
- ``eop*`` (e.g. ``eop.dat``) — simple whitespace table
  ``MJD  xp_arcsec  yp_arcsec  ut1_minus_utc_sec``.  (Discovery is by
  filename prefix — finals*/eopc04*/eop* — so other names are only
  reachable through ``EOPTable.from_file`` directly.)

UT1-UTC contains 1 s leap-second steps, so interpolating it directly
would smear each step over a day.  The table converts to the continuous
UT1-TAI at load time, interpolates that, and adds TAI-UTC back at the
query epoch.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

from pint_tpu_torch.time.scales import tai_minus_utc

__all__ = ["EOPTable", "get_eop", "eop_data_identity"]


class EOPTable:
    """Tabulated (xp, yp, UT1-UTC) vs UTC MJD with linear interpolation.

    Attributes are plain float64 arrays: ``mjd`` (UTC), ``xp``/``yp``
    [arcsec], ``dut1`` [s].  Queries outside the tabulated span clamp to
    the end values (matching the reference's astropy behavior of using
    the last available EOP rather than discontinuously dropping to 0).
    """

    #: first MJD of the leap-second era (1972-01-01); earlier rows (the
    #: C04 series starts in 1962) are dropped — no supported TOA can
    #: fall there (pint_tpu_torch.time.scales rejects pre-1972 UTC).
    MIN_MJD = 41317.0

    def __init__(self, mjd, xp, yp, dut1):
        mjd = np.asarray(mjd, np.float64)
        keep = mjd >= self.MIN_MJD
        order = np.argsort(mjd[keep])
        self.mjd = mjd[keep][order]
        self.xp = np.asarray(xp, np.float64)[keep][order]
        self.yp = np.asarray(yp, np.float64)[keep][order]
        self.dut1 = np.asarray(dut1, np.float64)[keep][order]
        if self.mjd.size == 0:
            raise ValueError("empty EOP table (after dropping pre-1972 rows)")
        # continuous realization for interpolation across leap seconds
        self._ut1_tai = self.dut1 - tai_minus_utc(
            np.floor(self.mjd).astype(np.int64)
        )

    def at(self, mjd_utc):
        """(xp [arcsec], yp [arcsec], UT1-UTC [s]) at UTC MJD(s)."""
        m = np.asarray(mjd_utc, np.float64)
        xp = np.interp(m, self.mjd, self.xp)
        yp = np.interp(m, self.mjd, self.yp)
        ut1_tai = np.interp(m, self.mjd, self._ut1_tai)
        dut1 = ut1_tai + tai_minus_utc(np.floor(m).astype(np.int64))
        return xp, yp, dut1

    # -- parsers ---------------------------------------------------------

    @classmethod
    def from_finals2000a(cls, path):
        """Parse the fixed-width IERS Bulletin A ``finals2000A`` layout."""
        mjd, xp, yp, dut1 = [], [], [], []
        with open(path, "r", errors="replace") as f:
            for line in f:
                if len(line) < 68:
                    continue
                try:
                    m = float(line[7:15])
                    x = line[18:27].strip()
                    y = line[37:46].strip()
                    u = line[58:68].strip()
                    if not (x and y and u):
                        continue  # prediction rows without values
                    mjd.append(m)
                    xp.append(float(x))
                    yp.append(float(y))
                    dut1.append(float(u))
                except ValueError:
                    continue
        if not mjd:
            raise ValueError(f"no EOP rows parsed from {path}")
        return cls(mjd, xp, yp, dut1)

    @classmethod
    def from_eopc04(cls, path):
        """Parse the whitespace-column IERS EOP C04 layout.  Both the
        classic ``yr mo dy MJD xp yp UT1-UTC ...`` and the v2 (2023+)
        ``yr mo dy hh MJD xp yp UT1-UTC ...`` layouts are accepted: the
        MJD column is located by value (the first entry after the
        calendar date that looks like an MJD)."""
        mjd, xp, yp, dut1 = [], [], [], []
        with open(path, "r", errors="replace") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 7:
                    continue
                try:
                    vals = [float(p) for p in parts[:8]]
                except ValueError:
                    continue  # header
                i_mjd = next(
                    (i for i in (3, 4) if 10000.0 < vals[i] < 100000.0), None
                )
                if i_mjd is None or len(vals) < i_mjd + 4:
                    continue
                mjd.append(vals[i_mjd])
                xp.append(vals[i_mjd + 1])
                yp.append(vals[i_mjd + 2])
                dut1.append(vals[i_mjd + 3])
        if not mjd:
            raise ValueError(f"no EOP rows parsed from {path}")
        return cls(mjd, xp, yp, dut1)

    @classmethod
    def from_simple(cls, path):
        """Parse ``MJD xp yp dut1`` whitespace rows (# comments ok)."""
        rows = []
        with open(path, "r", errors="replace") as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                parts = line.split()
                if len(parts) >= 4:
                    try:
                        rows.append([float(p) for p in parts[:4]])
                    except ValueError:
                        continue
        if not rows:
            raise ValueError(f"no EOP rows parsed from {path}")
        arr = np.asarray(rows, np.float64)
        return cls(arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3])

    @classmethod
    def from_file(cls, path):
        name = os.path.basename(path).lower()
        if name.startswith("finals"):
            return cls.from_finals2000a(path)
        if name.startswith("eopc04") or name.startswith("eop_c04"):
            return cls.from_eopc04(path)
        return cls.from_simple(path)


def _iers_dirs():
    from pint_tpu_torch.obs.datadirs import search_dirs

    return search_dirs("PINT_TORCH_IERS_DIR", "iers")


def _find_eop_file():
    """First EOP file in the search dirs, by preference order."""
    for d in _iers_dirs():
        names = sorted(os.listdir(d))
        for want in ("finals", "eopc04", "eop_c04", "eop"):
            for n in names:
                if n.lower().startswith(want):
                    return os.path.join(d, n)
    return None


def eop_data_identity():
    """Provenance string over the EOP search dirs (name, mtime, size),
    the key of :func:`get_eop`'s memoization."""
    from pint_tpu_torch.obs.datadirs import data_identity

    return data_identity(_iers_dirs())


_cached = None  # (identity, EOPTable-or-None)


def get_eop():
    """The active EOP table, or None (zero EOP).  Memoized on data
    provenance so installing/updating a finals file mid-process takes
    effect on the next prepared dataset."""
    global _cached
    ident = eop_data_identity()
    if _cached is not None and _cached[0] == ident:
        return _cached[1]
    path = _find_eop_file()
    table = None
    if path is not None:
        try:
            table = EOPTable.from_file(path)
        except (OSError, ValueError) as e:
            warnings.warn(f"failed to parse EOP file {path}: {e}; "
                          "proceeding with zero EOP (UT1=UTC, no polar motion)")
    _cached = (ident, table)
    return table
