"""Dispersion: DM Taylor series (pint_tpu models/dispersion.py:23-113,
``DispersionDM``).  delay[s] = DM_CONST * DM(t) / bfreq[MHz]^2 at the
barycentric radio frequency."""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch import DM_CONST
from pint_tpu_torch.models.astrometry import bary_freq_mhz
from pint_tpu_torch.models.component import DelayComponent, as_tensor


class DispersionDM(DelayComponent):
    category = "dispersion_constant"

    def __init__(self, num_dm_derivs=0):
        super().__init__()
        self.num_dm_derivs = num_dm_derivs
        self.params = (["DM"] + [f"DM{k}" for k in
                                 range(1, num_dm_derivs + 1)]
                       + ["DMEPOCH"])

    def prepare(self, toas, model, device):
        ep = model.values.get("DMEPOCH", np.nan)
        if np.isnan(ep):
            ep = model.values.get("PEPOCH", 0.0)
        t = np.asarray(toas.ticks).astype(np.float64) / 2**32
        # DM1.. are per YEAR^k (par-file convention)
        return {
            "dt_yr": as_tensor((t - ep) / (365.25 * 86400.0), device),
            "bfreq": as_tensor(bary_freq_mhz(toas, model), device),
        }

    def dm_at(self, values, ctx):
        dm = values["DM"]
        if self.num_dm_derivs:
            dt = ctx["dt_yr"]
            fact = 1.0
            power = dt
            for k in range(1, self.num_dm_derivs + 1):
                fact *= k
                dm = dm + values[f"DM{k}"] * power / fact
                power = power * dt
        return dm

    def delay(self, values, batch, ctx, delay_accum):
        return DM_CONST * self.dm_at(values, ctx) / ctx["bfreq"] ** 2

    def linear_params(self):
        return ("DM",) + tuple(
            f"DM{k}" for k in range(1, self.num_dm_derivs + 1))

    def _d_dm(self, ctx, name):
        """d DM(t) / d name: the Taylor monomial dt^k/k! (1 for DM)."""
        if name == "DM":
            return torch.ones_like(ctx["dt_yr"])
        k = int(name[2:])
        dt = ctx["dt_yr"]
        fact = 1.0
        power = dt
        for j in range(2, k + 1):
            fact *= j
            power = power * dt
        return power / fact

    def d_delay_d_param(self, values, batch, ctx, delay_accum, name):
        return DM_CONST * self._d_dm(ctx, name) / ctx["bfreq"] ** 2
