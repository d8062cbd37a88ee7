"""Absolute phase reference (pint_tpu models/absolute_phase.py,
``AbsPhase`` only).

The TZR TOA is a one-row :class:`~pint_tpu_torch.toa.TOATable` beside
the dataset — from :meth:`AbsPhase.make_tzr_toas` on ingest TOAs, or
from a carried-across case (:mod:`pint_tpu_torch.convert`) — evaluated
through the same chain with its own prepared ctx by the prepared model.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.models.component import PhaseComponent


class AbsPhase(PhaseComponent):
    category = "absolute_phase"

    def __init__(self):
        super().__init__()
        self.params = ["TZRMJD", "TZRFRQ"]

    def phase(self, values, batch, ctx, delay):
        # the TZR subtraction happens in PreparedModel._phase_raw_at
        return torch.zeros_like(delay)

    def make_tzr_toas(self, model, toas):
        """The one-TOA TOAs at TZRMJD/TZRSITE/TZRFRQ through full ingest
        (pint_tpu absolute_phase.py:42), or None without TZRMJD.  The
        raw par string goes through the tim-line path, so TZRMJD is UTC
        at a topocentric site and TDB at '@'."""
        from pint_tpu_torch.time.mjd import (mjd_string_to_day_frac,
                                             ticks_to_mjd_string_tdb)
        from pint_tpu_torch.toa import TOA, TOAs

        tzr_sec = model.values.get("TZRMJD", np.nan)
        if np.isnan(tzr_sec):
            return None
        site = model.meta.get("TZRSITE", "@")
        freq = model.values.get("TZRFRQ", np.inf)
        if not np.isfinite(freq) or freq == 0.0:
            freq = 0.0  # ingest maps 0 -> inf
        p = model.params.get("TZRMJD")
        raw = getattr(p, "raw", None)
        if raw is None:
            raw = ticks_to_mjd_string_tdb(int(round(tzr_sec * 2**32)), 16)
        day, num, den = mjd_string_to_day_frac(raw)
        return TOAs([TOA(day, num, den, 0.0, freq, site, {}, name="TZR")],
                    ephem=toas.ephem, planets=toas.planets)
