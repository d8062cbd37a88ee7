"""Absolute phase reference (pint_tpu models/absolute_phase.py,
``AbsPhase`` only).

The TZR TOA arrives as a one-row :class:`~pint_tpu_torch.toa.TOATable`
beside the dataset (the carried-across state, see
:mod:`pint_tpu_torch.convert`) and is evaluated through the same chain
with its own prepared ctx by the prepared model.
"""

from __future__ import annotations

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
