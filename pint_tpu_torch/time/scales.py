"""Time-scale transforms: UTC -> TAI -> TT -> TDB, owned natively.

The reference package gets these from astropy.time / erfa (C); with no such
dependency here, the chain is implemented directly:

- **UTC -> TAI**: embedded IERS leap-second table (public data, complete
  through the 2017-01-01 leap second — none have been announced since).
- **TAI -> TT**: the defining constant TT = TAI + 32.184 s.
- **TT -> TDB**: a truncated Fairhead & Bretagnon (1990)-style harmonic
  series.  The full series (as in erfa ``dtdb``) has ~800 terms and reaches
  ~ns; the leading terms embedded here reach ~2 microseconds.  That bounds
  absolute barycentric accuracy of the *builtin* path; it cancels exactly
  in simulate->fit self-consistency, and the transform is pluggable: a
  user-supplied time-ephemeris table (or SPK TDB kernel, see
  :mod:`pint_tpu_torch.ephem`) restores ns accuracy.  (Reference analogue: the
  "ephem" TDB method, observatory/__init__.py:518.)

UT1 is approximated by UTC (|UT1-UTC| < 0.9 s by definition of leap
seconds); an IERS finals table can be supplied to refine Earth rotation,
see :mod:`pint_tpu_torch.obs.erot`.
"""

from __future__ import annotations

import numpy as np

TT_MINUS_TAI = 32.184  # seconds, exact by definition

# (first MJD on which the offset applies, TAI-UTC seconds) — IERS table,
# era of integer leap seconds (1972+).  Public data.
_LEAP_TABLE = np.array(
    [
        (41317, 10),
        (41499, 11),
        (41683, 12),
        (42048, 13),
        (42413, 14),
        (42778, 15),
        (43144, 16),
        (43509, 17),
        (43874, 18),
        (44239, 19),
        (44786, 20),
        (45151, 21),
        (45516, 22),
        (46247, 23),
        (47161, 24),
        (47892, 25),
        (48257, 26),
        (48804, 27),
        (49169, 28),
        (49534, 29),
        (50083, 30),
        (50630, 31),
        (51179, 32),
        (53736, 33),
        (54832, 34),
        (56109, 35),
        (57204, 36),
        (57754, 37),
    ],
    dtype=np.int64,
)


def tai_minus_utc(mjd_day):
    """TAI-UTC in seconds for (arrays of) integer UTC MJD days."""
    mjd_day = np.asarray(mjd_day, dtype=np.int64)
    idx = np.searchsorted(_LEAP_TABLE[:, 0], mjd_day, side="right") - 1
    if np.any(idx < 0):
        raise ValueError("UTC before 1972 is not supported (pre-leap-second era)")
    return _LEAP_TABLE[idx, 1].astype(np.float64)


# Leading terms of the TDB-TT harmonic series (Fairhead & Bretagnon 1990
# form): amplitude [s] * sin(rate [rad/millennium] * T + phase [rad]),
# T in TT julian millennia since J2000.  Dominant terms only (~2 us trunc.).
_FB_TERMS = np.array(
    [
        # amplitude,        rate,              phase
        (1.656674564e-3, 6283.075849991, 6.240054195),   # Earth mean anomaly (annual)
        (2.2417471e-5, 5753.384884897, 4.296977442),
        (1.3839792e-5, 12566.151699983, 6.196904410),    # semi-annual
        (4.770086e-6, 529.690965095, 0.444401603),       # Jupiter
        (4.676740e-6, 6069.776754553, 4.021195093),
        (2.256707e-6, 213.299095438, 5.543113262),       # Saturn
        (1.694205e-6, -3.523118349, 5.025132748),        # Moon
        (1.554905e-6, 77713.771467920, 5.198467090),
        (1.276839e-6, 7860.419392439, 5.988822341),
        (1.193379e-6, 5223.693919802, 3.649823730),
        (1.115322e-6, 3930.209696220, 1.422745069),
        (0.794185e-6, 11506.769769794, 2.322313077),
        (0.600309e-6, 1577.343542448, 2.678271909),
        (0.496817e-6, 6208.294251424, 5.696701824),
        (0.486306e-6, 5884.926846583, 0.520007179),
        (0.468597e-6, 6244.942814354, 5.866398759),
        (0.447061e-6, 26.298319800, 3.615796498),
        (0.435206e-6, -398.149003408, 4.349338347),
        (0.432392e-6, 74.781598567, 2.435898309),
        (0.375510e-6, 5507.553238667, 4.103476804),
    ]
)


_COMPILED_TDBTT: dict = {}  # data-file path -> CompiledEphemeris | None


def tdb_minus_tt_seconds(tt_sec_since_j2000):
    """TDB-TT [s] for float64 TT seconds since MJD 51544.5 (J2000) TT.

    Prefers the compiled numerical time ephemeris (integral of the
    geocentric time-dilation rate, ~tens of ns vs tempo2 — see
    tools/build_ephemeris.py) when its table covers the epoch; falls
    back to the truncated harmonic series (~2 us) otherwise.  Keyed by
    the resolved data path so $PINT_TORCH_EPHEM_BUILTIN switches datasets
    mid-process (the calibration tooling relies on that).
    """
    try:
        from pint_tpu_torch.ephem import _builtin
        from pint_tpu_torch.ephem.compiled import data_path

        key = data_path()
        if key not in _COMPILED_TDBTT:
            # reuse the memoized builtin provider (one npz load and one
            # in-memory table set per path, shared with positions)
            eph = _builtin()
            _COMPILED_TDBTT[key] = (
                eph if "tdbtt" in getattr(eph, "_seg", {}) else None)
        table = _COMPILED_TDBTT[key]
    except Exception:
        table = None
    if table is not None:
        try:
            return table.tdb_minus_tt(tt_sec_since_j2000)
        except ValueError:
            pass  # epoch outside the compiled span: harmonic fallback
    t_millennia = np.asarray(tt_sec_since_j2000, dtype=np.float64) / (
        86400.0 * 365250.0
    )
    amp = _FB_TERMS[:, 0][:, None]
    rate = _FB_TERMS[:, 1][:, None]
    phase = _FB_TERMS[:, 2][:, None]
    terms = amp * np.sin(rate * np.atleast_1d(t_millennia)[None, :] + phase)
    out = terms.sum(axis=0)
    if np.ndim(tt_sec_since_j2000) == 0:
        return float(out[0])
    return out
