"""Damour-Deruelle binary (pint_tpu models/binary/dd.py:33-100,
``BinaryDD`` only): Roemer + Einstein delays through the second-order
inverse timing formula, Shapiro delay and aberration."""

from __future__ import annotations

import math

import numpy as np
import torch

from pint_tpu_torch import T_SUN_S
from pint_tpu_torch.models.binary.base import BinaryComponent
from pint_tpu_torch.models.binary.kepler import true_anomaly


class BinaryDD(BinaryComponent):
    epoch_param = "T0"

    def __init__(self):
        super().__init__()
        self.params = ["PB", "PBDOT", "XPBDOT", "T0", "A1", "XDOT", "ECC",
                       "EDOT", "OM", "OMDOT", "GAMMA", "M2", "SINI", "DR",
                       "DTH", "A0", "B0"]

    def defaults(self):
        return {"T0": 0.0, "PB": np.nan, "PBDOT": 0.0, "XPBDOT": 0.0,
                "A1": 0.0, "XDOT": 0.0, "ECC": 0.0, "EDOT": 0.0, "OM": 0.0,
                "OMDOT": 0.0, "GAMMA": 0.0, "M2": 0.0, "SINI": 0.0,
                "DR": 0.0, "DTH": 0.0, "A0": 0.0, "B0": 0.0}

    def dd_quantities(self, values, dt, ctx, nu, forb):
        """(a1, omega, sini, tm2, gamma, dr, dth) for the delay kernel."""
        k = values["OMDOT"] / (2.0 * math.pi * forb)
        return dict(
            a1=values["A1"] + dt * values["XDOT"],
            omega=values["OM"] + k * nu,
            sini=values["SINI"],
            tm2=T_SUN_S * values["M2"],
            gamma=values["GAMMA"],
            dr=values["DR"],
            dth=values["DTH"],
        )

    def binary_delay(self, values, dt, ctx):
        E, ecc, forb = self.eccentric_anomaly(values, dt, ctx)
        sE, cE = torch.sin(E), torch.cos(E)
        nu = true_anomaly(E, ecc)
        q = self.dd_quantities(values, dt, ctx, nu, forb)
        a1, omega, gamma = q["a1"], q["omega"], q["gamma"]
        er = ecc * (1.0 + q["dr"])
        eth = ecc * (1.0 + q["dth"])
        sw, cw = torch.sin(omega), torch.cos(omega)
        alpha = a1 * sw
        beta = a1 * torch.sqrt(1.0 - eth * eth) * cw
        # Roemer (Eq. 48) + Einstein (Eq. 25) and their E-derivatives
        dre = alpha * (cE - er) + (beta + gamma) * sE
        drep = -alpha * sE + (beta + gamma) * cE
        drepp = -alpha * cE - (beta + gamma) * sE
        one_m_ecosE = 1.0 - ecc * cE
        nhat = 2.0 * math.pi * forb / one_m_ecosE
        nd = nhat * drep
        # inverse timing formula, Eq. 46-52 second order
        inv = dre * (
            1.0 - nd + nd * nd
            + 0.5 * nhat * nhat * dre * drepp
            - 0.5 * ecc * sE / one_m_ecosE * nhat * nhat * dre * drep
        )
        # Shapiro (Eq. 26)
        root = torch.sqrt(1.0 - ecc * ecc)
        bracket = one_m_ecosE - q["sini"] * (sw * (cE - ecc)
                                             + root * cw * sE)
        shap = -2.0 * q["tm2"] * torch.log(bracket)
        # aberration (Eq. 27)
        ab = values["A0"] * (torch.sin(omega + nu) + ecc * sw) \
            + values["B0"] * (torch.cos(omega + nu) + ecc * cw)
        return inv + shap + ab
