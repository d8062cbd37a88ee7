"""Exact MJD handling: string parsing, UTC/TDB -> device ticks.

The device-side time coordinate is **int64 ticks of 2^-32 s since
MJD 51544.5 TDB** (J2000).  All conversions here are exact integer /
rational arithmetic on the host (python bigints — no float rounding at
all until the final tick quantization of 2^-32 s ~ 0.23 ns), replacing the
reference's longdouble + astropy (jd1, jd2) machinery
(reference: src/pint/pulsar_mjd.py:255-365 ``str_to_mjds``/``mjds_to_str``).

UTC MJDs follow the "pulsar_mjd" convention (reference pulsar_mjd.py:86):
the fractional part is the fraction of an 86400-s day even on leap-second
days (times *during* a leap second are unrepresentable, as in tempo).
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.time.scales import TT_MINUS_TAI, tai_minus_utc, tdb_minus_tt_seconds

#: MJD of the tick epoch (J2000, TDB scale)
EPOCH_MJD = 51544
EPOCH_FRAC = 0.5  # epoch is MJD 51544.5

TICKS_PER_SEC_INT = 2**32
SECS_PER_DAY_INT = 86400

#: ticks value of the epoch itself (by construction zero)
MJD_EPOCH_TICKS = 0

# TT-TAI = 32.184 s exactly; as an exact rational in ticks:
_TT_MINUS_TAI_TICKS = (32184 * TICKS_PER_SEC_INT) // 1000  # exact: 32.184*2^32


def mjd_string_to_day_frac(s: str):
    """Parse an MJD string to (int day, int frac_num, int frac_den).

    Exact decimal parsing: "53478.2858714192189" ->
    (53478, 2858714192189, 10**13).  Handles sign, D/E exponents
    (tempo par files use Fortran 'D'), and bare integers.
    """
    s = s.strip().upper().replace("D", "E")
    if "E" in s:
        # exponent form: normalize via decimal shifting, exactly
        mant, exp = s.split("E")
        exp = int(exp)
    else:
        mant, exp = s, 0
    neg = mant.startswith("-")
    mant = mant.lstrip("+-")
    if "." in mant:
        ipart, fpart = mant.split(".")
    else:
        ipart, fpart = mant, ""
    digits = (ipart + fpart) or "0"
    # value = digits * 10^(exp - len(fpart))
    shift = exp - len(fpart)
    num = int(digits)
    if neg:
        num = -num
    if shift >= 0:
        num *= 10**shift
        den = 1
    else:
        den = 10 ** (-shift)
    day, rem = divmod(num, den)  # floor division: rem >= 0 even for neg
    return int(day), int(rem), int(den)


def _day_frac_to_ticks_tdb(day, frac_num, frac_den, extra_sec_exact=0):
    """Exact: ticks since epoch for a TDB-scale (day + frac) MJD.

    extra_sec_exact: additional seconds as an exact (num, den) tuple or int.
    """
    # (day - EPOCH) days + frac - 0.5 day, all over frac_den, in ticks:
    # ticks = ((day-51544)*86400 + (frac_num/frac_den)*86400 - 43200) * 2^32
    base = (day - EPOCH_MJD) * SECS_PER_DAY_INT - 43200
    t = base * TICKS_PER_SEC_INT * frac_den
    t += frac_num * SECS_PER_DAY_INT * TICKS_PER_SEC_INT
    if isinstance(extra_sec_exact, tuple):
        en, ed = extra_sec_exact
        # round((t/frac_den) + (en/ed)*2^32) with a common denominator
        t = t * ed + en * TICKS_PER_SEC_INT * frac_den
        den = frac_den * ed
    else:
        t += extra_sec_exact * TICKS_PER_SEC_INT * frac_den
        den = frac_den
    # round-half-away-from-zero on the exact rational t/den
    q, r = divmod(t, den)
    if 2 * r >= den:
        q += 1
    return q


def mjd_to_ticks_tdb(day: int, frac_num: int, frac_den: int) -> int:
    """Ticks for an MJD already in the TDB scale (e.g. PEPOCH with UNITS TDB)."""
    return _day_frac_to_ticks_tdb(day, frac_num, frac_den)


def mjd_to_ticks_utc(day, frac_num, frac_den, clock_offset_sec=0.0):
    """Ticks (TDB) for a UTC pulsar-MJD, through the full scale chain.

    clock_offset_sec: observatory clock correction (obs->UTC), float64
    seconds (clock corrections are ~us — f64 exact enough by 9 orders).
    UTC -> TAI: integer leap seconds; TAI -> TT: +32.184 s (exact rational);
    TT -> TDB: harmonic series in f64 (see scales.py accuracy note).
    """
    leap = int(tai_minus_utc(day))
    # TT ticks, exactly
    tt_ticks = _day_frac_to_ticks_tdb(
        day, frac_num, frac_den, extra_sec_exact=(leap * 1000 + 32184, 1000)
    )
    # clock correction + TDB-TT in float (both small): convert to ticks
    tt_sec_f64 = tt_ticks / float(TICKS_PER_SEC_INT)
    dtdb = tdb_minus_tt_seconds(tt_sec_f64)
    small = float(dtdb) + float(clock_offset_sec)
    return tt_ticks + int(round(small * TICKS_PER_SEC_INT))


def mjd_float_to_ticks_tdb(mjd) -> np.ndarray:
    """Vectorized: float64 TDB MJD(s) -> int64 ticks (0.23 ns quantization).

    For programmatic epochs (simulation grids etc.); f64 MJD resolution is
    ~10 us at MJD ~5e4, so exactness is moot — use the string path for
    precision inputs.
    """
    mjd = np.asarray(mjd, dtype=np.float64)
    # int64 tick range covers +/-2^31 s around J2000: MJD ~ 26690..76398
    if np.any(mjd < 26690.0) or np.any(mjd > 76398.0):
        raise ValueError(
            "MJD outside the representable tick range (26690..76398, "
            "i.e. +/-68 yr around J2000)"
        )
    day = np.floor(mjd).astype(np.int64)
    frac = mjd - day
    base = (day - EPOCH_MJD) * SECS_PER_DAY_INT * TICKS_PER_SEC_INT
    off = np.round(
        frac * (SECS_PER_DAY_INT * float(TICKS_PER_SEC_INT))
    ).astype(np.int64) - 43200 * TICKS_PER_SEC_INT
    return base + off


def ticks_to_mjd_tdb(ticks):
    """Ticks -> (int day, longdouble frac in [0,1)) in the TDB scale."""
    ticks = np.asarray(ticks, dtype=np.int64)
    total = ticks + np.int64(43200) * np.int64(TICKS_PER_SEC_INT)
    day_ticks = np.int64(SECS_PER_DAY_INT) * np.int64(TICKS_PER_SEC_INT)
    day = total // day_ticks
    rem = total - day * day_ticks
    frac = rem.astype(np.longdouble) / np.longdouble(day_ticks)
    return (day + EPOCH_MJD).astype(np.int64), frac


def ticks_to_mjd_string_utc(ticks: int, clock_offset_sec: float = 0.0,
                            ndigits: int = 16) -> str:
    """Invert the UTC->TDB chain: TDB ticks -> site-UTC pulsar-MJD string
    (for .tim writing; reference: toa.py:566 format_toa_line).

    clock_offset_sec is subtracted (the same offset mjd_to_ticks_utc
    added).  Exact integer arithmetic except the small TDB-TT + clock
    terms (~ms), which are f64 — sub-ns on the output."""
    ticks = int(ticks)
    tdb_sec = ticks / float(TICKS_PER_SEC_INT)
    dtdb = float(tdb_minus_tt_seconds(tdb_sec))
    tt_ticks = ticks - int(round((dtdb + clock_offset_sec)
                                 * TICKS_PER_SEC_INT))
    # TT -> TAI -> UTC; leap lookup from the TT day, re-checked on the
    # UTC day (they can differ across a midnight boundary)
    day_guess = int(
        np.floor(tt_ticks / float(TICKS_PER_SEC_INT) / SECS_PER_DAY_INT
                 + EPOCH_MJD + EPOCH_FRAC)
    )
    for _ in range(2):
        leap = int(tai_minus_utc(day_guess))
        utc_ticks = tt_ticks - _TT_MINUS_TAI_TICKS \
            - leap * TICKS_PER_SEC_INT
        total = utc_ticks + 43200 * TICKS_PER_SEC_INT
        day = total // (SECS_PER_DAY_INT * TICKS_PER_SEC_INT) + EPOCH_MJD
        if day == day_guess:
            break
        day_guess = int(day)
    return _total_ticks_to_mjd_string(total, ndigits)


def _total_ticks_to_mjd_string(total: int, ndigits: int) -> str:
    """Midnight-based tick count -> decimal MJD string, rounding the
    fraction with carry into the day (shared by the TDB and UTC string
    paths)."""
    day_ticks = SECS_PER_DAY_INT * TICKS_PER_SEC_INT
    day, rem = divmod(total, day_ticks)
    scaled = rem * 10**ndigits
    q, r = divmod(scaled, day_ticks)
    if 2 * r >= day_ticks:
        q += 1
        if q == 10**ndigits:
            q = 0
            day += 1
    return f"{day + EPOCH_MJD}.{q:0{ndigits}d}"


def ticks_to_mjd_string_tdb(ticks: int, ndigits: int = 16) -> str:
    """One tick value -> decimal MJD string with ndigits fractional digits."""
    total = int(ticks) + 43200 * TICKS_PER_SEC_INT
    return _total_ticks_to_mjd_string(total, ndigits)
