"""Spindown: rotation-phase Taylor series (pint_tpu models/spindown.py).

The giant F0 * (t - PEPOCH) term goes through the exact fixed-point
path (:func:`pint_tpu_torch.fixedpoint.phase_f0_t`, kernel K1 on CUDA);
the delay term and F1, F2, ... stay float64.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch import fixedpoint as fp
from pint_tpu_torch.models.component import PhaseComponent, as_tensor


class Spindown(PhaseComponent):
    category = "spindown"

    def __init__(self, num_freq_derivs=1):
        super().__init__()
        self.num_freq_derivs = num_freq_derivs
        self.params = (["F0"] + [f"F{k}" for k in
                                 range(1, num_freq_derivs + 1)]
                       + ["PEPOCH"])

    def defaults(self):
        d = {f"F{k}": 0.0 for k in range(1, self.num_freq_derivs + 1)}
        d["PEPOCH"] = 0.0
        return d

    def prepare(self, toas, model, device):
        pepoch_ticks = model.epoch_ticks.get(
            "PEPOCH", int(round(model.values["PEPOCH"] * 2**32)))
        dt = np.asarray(toas.ticks, np.int64) - np.int64(pepoch_ticks)
        return {"dt_ticks": as_tensor(dt, device, dtype=torch.int64)}

    def phase(self, values, batch, ctx, delay):
        dt_ticks = ctx["dt_ticks"]
        f0 = values["F0"]
        n, frac = fp.phase_f0_t(f0, dt_ticks)
        # remaining terms in f64: -F0*delay + sum_k Fk dt^(k+1)/(k+1)!
        dt = fp.ticks_to_seconds(dt_ticks) - delay
        small = -f0 * delay
        fact = 1.0
        power = dt * dt
        for k in range(1, self.num_freq_derivs + 1):
            fact *= k + 1
            small = small + values[f"F{k}"] * power / fact
            power = power * dt
        return n, frac + small

    def linear_params(self):
        """F1..Fk are linear with the Taylor monomial as the column; F0
        multiplies the delay and divides the time conversion."""
        return tuple(f"F{k}" for k in range(1, self.num_freq_derivs + 1))

    def d_phase_d_param(self, values, batch, ctx, delay, name):
        k = int(name[1:])
        dt = fp.ticks_to_seconds(ctx["dt_ticks"]) - delay
        fact = 1.0
        power = dt * dt
        for _ in range(1, k):
            power = power * dt
        for j in range(1, k + 1):
            fact *= j + 1
        return power / fact
