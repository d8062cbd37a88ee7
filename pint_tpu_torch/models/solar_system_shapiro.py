"""Solar-system Shapiro delay, Sun only (pint_tpu
models/solar_system_shapiro.py:39-100): -2 T_sun ln((r - r.n)/AU)."""

from __future__ import annotations

import torch

from pint_tpu_torch import AU_LS, T_SUN_S
from pint_tpu_torch.models.astrometry import _unit_vector
from pint_tpu_torch.models.component import DelayComponent


def _obj_shapiro(obj_pos_ls, psr_dir, t_obj):
    """-2 T ln((r - r.n)/AU): obj_pos is obs -> body [ls]."""
    r = torch.sqrt(torch.sum(obj_pos_ls * obj_pos_ls, dim=-1))
    rcos = torch.sum(obj_pos_ls * psr_dir, dim=-1)
    return -2.0 * t_obj * torch.log((r - rcos) / AU_LS)


class SolarSystemShapiro(DelayComponent):
    category = "solar_system_shapiro"
    #: delay() recomputes the pulsar direction from RAJ/DECJ
    reads_params = ("RAJ", "DECJ", "ELONG", "ELAT")

    def __init__(self):
        super().__init__()
        self.params = ["PLANET_SHAPIRO"]

    def delay(self, values, batch, ctx, delay_accum):
        n = _unit_vector(values["RAJ"], values["DECJ"])
        return _obj_shapiro(batch.obs_sun_pos, n, T_SUN_S)
