"""TOA table (host) and TOA batch (device tensors), the port of the
parts of ``pint_tpu.toa`` the timing fit reads.

:class:`TOATable` holds what ``pint_tpu.toa.TOAs`` carries after ingest
— exact int64 TDB ticks, observing frequency, error, observatory
geometry and the flags — as numpy arrays; flags are kept columnar, each
key as an index into a names array.  Ingest itself (tim parsing,
clocks, ephemerides) is not part of the port yet: a table arrives from
:mod:`pint_tpu_torch.convert`.

:class:`TOABatch` is the device struct-of-arrays counterpart of
``pint_tpu.toa.TOABatch`` (toa.py:635-651), with the same fields.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch


@dataclass
class TOATable:
    """Host-side TOA table.

    ticks: int64 TDB arrival time, 2^-32 s since J2000.
    Geometry in light-seconds / ls-per-s, ICRS axes: ssb_obs_pos,
    ssb_obs_vel, obs_sun_pos (N, 3).
    flags: {key: (names (n_k,) str, index (N,) int32)} — TOA i carries
    ``key = names[index[i]]``, or lacks the key where index is -1."""

    ticks: np.ndarray
    freq_mhz: np.ndarray
    error_us: np.ndarray
    mjd_float: np.ndarray
    ssb_obs_pos: np.ndarray
    ssb_obs_vel: np.ndarray
    obs_sun_pos: np.ndarray
    flags: Dict[str, Tuple[np.ndarray, np.ndarray]] = field(
        default_factory=dict)

    def __len__(self):
        return int(self.ticks.shape[0])

    def flag_equals(self, key, value) -> np.ndarray:
        """Boolean mask of TOAs whose flag ``key`` equals ``value``."""
        if key not in self.flags:
            return np.zeros(len(self), dtype=bool)
        names, index = self.flags[key]
        hit = np.flatnonzero(np.asarray(names) == str(value))
        if hit.size == 0:
            return np.zeros(len(self), dtype=bool)
        return np.asarray(index) == int(hit[0])

    def to_batch(self, device) -> "TOABatch":
        dev = torch.device(device)

        def t(a, dtype=torch.float64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        return TOABatch(
            ticks=t(self.ticks, torch.int64),
            freq_mhz=t(self.freq_mhz),
            error_s=t(self.error_us * 1e-6),
            ssb_obs_pos=t(self.ssb_obs_pos),
            ssb_obs_vel=t(self.ssb_obs_vel),
            obs_sun_pos=t(self.obs_sun_pos),
            planet_pos=torch.zeros((0, len(self), 3), dtype=torch.float64,
                                   device=dev),
        )


@dataclass
class TOABatch:
    """Device struct-of-arrays TOA batch (pint_tpu toa.py:635-651).
    planet_pos is (6, N, 3) for venus..neptune, or empty when planets
    were not loaded."""

    ticks: torch.Tensor
    freq_mhz: torch.Tensor
    error_s: torch.Tensor
    ssb_obs_pos: torch.Tensor
    ssb_obs_vel: torch.Tensor
    obs_sun_pos: torch.Tensor
    planet_pos: Optional[torch.Tensor]

    def __len__(self):
        return int(self.ticks.shape[0])
