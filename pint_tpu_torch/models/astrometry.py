"""Equatorial astrometry: Roemer delay, parallax, proper motion
(pint_tpu models/astrometry.py:36-130), and the barycentric observing
frequency (:224)."""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch import SECS_PER_JULIAN_YEAR
from pint_tpu_torch.models.component import DelayComponent, as_tensor

#: mas/yr -> rad/s
_MASYR = np.deg2rad(1.0 / 3.6e6) / SECS_PER_JULIAN_YEAR
#: 1 kpc in light-seconds (IAU pc)
_KPC_LS = 3.0856775814913673e19 / 299792458.0


def _unit_vector(lon, lat):
    clat = torch.cos(lat)
    return torch.stack(
        [clat * torch.cos(lon), clat * torch.sin(lon), torch.sin(lat)],
        dim=-1)


class AstrometryEquatorial(DelayComponent):
    category = "astrometry"

    def __init__(self):
        super().__init__()
        self.params = ["RAJ", "DECJ", "PMRA", "PMDEC", "PX", "POSEPOCH"]

    def prepare(self, toas, model, device):
        posepoch = model.values.get("POSEPOCH", np.nan)
        if np.isnan(posepoch):
            posepoch = model.values.get("PEPOCH", 0.0)
        t_sec = np.asarray(toas.ticks).astype(np.float64) / 2**32
        return {"dt_pos": as_tensor(t_sec - posepoch, device)}

    def psr_dir(self, values, ctx):
        """Unit vector obs -> pulsar in ICRS at each TOA (with PM)."""
        dt = ctx["dt_pos"]
        ra = values["RAJ"]
        dec = values["DECJ"]
        cosdec = torch.cos(dec)
        ra_t = ra + values["PMRA"] * _MASYR * dt / torch.where(
            cosdec == 0, torch.ones_like(cosdec), cosdec)
        dec_t = dec + values["PMDEC"] * _MASYR * dt
        return _unit_vector(ra_t, dec_t)

    def delay(self, values, batch, ctx, delay_accum):
        n = self.psr_dir(values, ctx)
        r = batch.ssb_obs_pos
        roemer = -torch.sum(n * r, dim=-1)
        # parallax (|r|^2 - (r.n)^2) / (2 d), 1/d [1/ls] = PX / _KPC_LS
        r2 = torch.sum(r * r, dim=-1)
        rn = -roemer
        inv_d_ls = values["PX"] / _KPC_LS
        return roemer + 0.5 * (r2 - rn * rn) * inv_d_ls


def psr_dir_static(model) -> np.ndarray:
    """SSB -> pulsar ICRS unit vector from the model's current RAJ/DECJ
    (no proper motion), host-side."""
    v = model.values
    if "RAJ" in v and not np.isnan(v.get("RAJ", np.nan)):
        ra, dec = float(v["RAJ"]), float(v["DECJ"])
        return np.array(
            [np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra), np.sin(dec)])
    raise ValueError("model has no equatorial astrometry (RAJ/DECJ)")


def bary_freq_mhz(toas, model) -> np.ndarray:
    """Barycentric observing frequency (MHz) per TOA: first-order
    Doppler ``f * (1 - n.v_obs/c)`` (ssb_obs_vel is in ls/s)."""
    try:
        n = psr_dir_static(model)
    except ValueError:
        return np.asarray(toas.freq_mhz)
    beta = np.asarray(toas.ssb_obs_vel) @ n
    return np.asarray(toas.freq_mhz) * (1.0 - beta)
