"""Shared binary machinery (pint_tpu models/binary/base.py:105-166):
exact-tick epoch offset, PB-parameterized orbit count, Keplerian
eccentric anomaly (the ``KeplerianMixin`` of binary/bt.py)."""

from __future__ import annotations

import math

import numpy as np
import torch

from pint_tpu_torch import fixedpoint as fp
from pint_tpu_torch.models.binary.kepler import (kepler_eccentric_anomaly,
                                                 newton_iters_for)
from pint_tpu_torch.models.component import DelayComponent


class BinaryComponent(DelayComponent):
    """Base for binary families with the PB orbit parameterization.
    Subclasses set ``epoch_param`` and implement ``binary_delay``."""

    category = "pulsar_system"
    epoch_param: str = "T0"
    #: dt_epoch subtracts the accumulated delay chain
    reads_delay_accum = True

    def prepare(self, toas, model, device):
        ticks = model.epoch_ticks.get(
            self.epoch_param,
            int(round(model.values[self.epoch_param] * 2**32)))
        dt0 = fp.ticks_to_seconds(torch.as_tensor(
            np.asarray(toas.ticks, np.int64) - np.int64(ticks)))
        # static Kepler depth from the prepare-time eccentricity class
        # (plus EDOT drift over the span), chosen host-side
        ecc = abs(float(model.values.get("ECC", float("nan"))))
        edot = abs(float(model.values.get("EDOT", 0.0) or 0.0))
        span = float(torch.max(torch.abs(dt0))) if dt0.numel() else 0.0
        return {
            "dt0": dt0.to(device),
            "epoch_ref": torch.tensor(ticks / 2**32, dtype=torch.float64,
                                      device=device),
            "kepler_iters": newton_iters_for(ecc + edot * span),
        }

    def dt_epoch(self, values, ctx, accum):
        """Barycentric time since the orbit epoch [s]: exact tick base,
        differentiable epoch shift, minus the accumulated delay."""
        return ctx["dt0"] - (values[self.epoch_param] - ctx["epoch_ref"]) \
            - accum

    def orbits_and_freq(self, values, dt):
        """(orbit count since epoch, orbital frequency [1/s]) at dt."""
        pb = values["PB"]
        pbd = values["PBDOT"] + values["XPBDOT"]
        u_ = dt / pb
        return u_ - 0.5 * pbd * u_ * u_, (1.0 - pbd * u_) / pb

    def orbit_phase(self, orbits):
        """Orbit phase in (-pi, pi]: reduce the count before scaling."""
        return 2.0 * math.pi * (orbits - torch.round(orbits))

    def delay(self, values, batch, ctx, delay_accum):
        dt = self.dt_epoch(values, ctx, delay_accum)
        return self.binary_delay(values, dt, ctx)

    def binary_delay(self, values, dt, ctx):
        raise NotImplementedError

    # -- Keplerian families -------------------------------------------------
    def ecc_reach(self, values, ticks):
        """|ECC| + |EDOT| * max|t - T0|: the eccentricity the Kepler
        solve can see at ``values`` over the dataset (host-side)."""
        ecc = abs(float(values.get("ECC", float("nan"))))
        edot = abs(float(values.get("EDOT", 0.0) or 0.0))
        span = 0.0
        if edot:
            t0 = np.int64(int(round(float(values[self.epoch_param])
                                    * 2**32)))
            dt0 = (np.asarray(ticks, np.int64) - t0).astype(np.float64) \
                * (1.0 / 2**32)
            span = float(np.max(np.abs(dt0))) if dt0.size else 0.0
        return ecc + edot * span

    def eccentric_anomaly(self, values, dt, ctx):
        """(E, ecc, orbital freq) at dt = t - T0, at the ctx's static
        Newton depth."""
        orbits, forb = self.orbits_and_freq(values, dt)
        mean_anom = self.orbit_phase(orbits)
        ecc = values["ECC"] + dt * values["EDOT"]
        return (kepler_eccentric_anomaly(mean_anom, ecc,
                                         ctx["kepler_iters"]), ecc, forb)
