"""Host-side precision time layer (pint_tpu time/), numpy and exact
Python integers: UTC -> TAI -> TT -> TDB and exact MJD strings to int64
ticks of 2^-32 s since MJD 51544.5 TDB."""

from pint_tpu_torch.time.mjd import (  # noqa: F401
    MJD_EPOCH_TICKS,
    mjd_float_to_ticks_tdb,
    mjd_string_to_day_frac,
    mjd_to_ticks_tdb,
    mjd_to_ticks_utc,
    ticks_to_mjd_string_tdb,
    ticks_to_mjd_tdb,
)
from pint_tpu_torch.time.scales import (  # noqa: F401
    TT_MINUS_TAI,
    tai_minus_utc,
    tdb_minus_tt_seconds,
)
