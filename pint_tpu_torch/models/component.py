"""Component base classes, the port of ``pint_tpu.models.component``.

A component instance holds only static structure (its parameter names
and mask selects); ``prepare(toas, model, device)`` returns a ctx dict
of per-dataset tensors on ``device``; ``delay``/``phase`` are functions
of the ``{name: 0-d float64 tensor}`` values dict, the batch and the
ctx, composable with ``torch.func`` transforms.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


class Component:
    """Base component."""

    category: str = ""
    #: True when ``delay()`` reads the accumulated delay of earlier chain
    #: members (then upstream parameters are never exactly linear)
    reads_delay_accum: bool = False
    #: OTHER components' parameters this component reads from values
    reads_params: tuple = ()

    def __init__(self):
        self.params: List[str] = []

    def has_param(self, name) -> bool:
        return name in self.params

    def prepare(self, toas, model, device) -> dict:
        """Static per-dataset tensors on ``device``."""
        return {}

    def defaults(self) -> dict:
        """{name: value} of the parameters a par may leave out (NaN where
        the reference has no neutral value)."""
        return {}

    def linear_params(self) -> tuple:
        """Parameters whose phase contribution is linear with a
        closed-form design column (d_delay_d_param / d_phase_d_param
        return the EXACT derivative)."""
        return ()


class DelayComponent(Component):
    def delay(self, values, batch, ctx, delay_accum):
        """Delay in seconds (float64, shape of batch)."""
        raise NotImplementedError

    def d_delay_d_param(self, values, batch, ctx, delay_accum, name):
        raise NotImplementedError(
            f"{type(self).__name__} declares {name} linear but defines "
            "no d_delay_d_param")


class PhaseComponent(Component):
    def phase(self, values, batch, ctx, delay):
        """Phase turns: float64 tensor, or (int64, float64) pair."""
        raise NotImplementedError

    def d_phase_d_param(self, values, batch, ctx, delay, name):
        raise NotImplementedError(
            f"{type(self).__name__} declares {name} linear but defines "
            "no d_phase_d_param")


def mask_from_select(select: tuple, toas) -> np.ndarray:
    """Resolve a mask-parameter selector to a boolean numpy array over
    the TOAs.  Forms: ("flag", key, value) | ("mjd", lo, hi) |
    ("freq", lo, hi) | ("all",).  (The ("tel", obs) form needs the
    observatory registry, which the port does not carry yet.)"""
    n = len(toas)
    kind = select[0]
    if kind in ("all", ""):
        return np.ones(n, dtype=bool)
    if kind == "flag":
        return toas.flag_equals(select[1], select[2])
    if kind == "mjd":
        lo, hi = float(select[1]), float(select[2])
        return (toas.mjd_float >= lo) & (toas.mjd_float <= hi)
    if kind == "freq":
        lo, hi = float(select[1]), float(select[2])
        return (toas.freq_mhz >= lo) & (toas.freq_mhz <= hi)
    raise ValueError(f"unsupported mask selector {select!r}")


def as_tensor(a, device, dtype=torch.float64):
    """Host array -> contiguous tensor on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)
