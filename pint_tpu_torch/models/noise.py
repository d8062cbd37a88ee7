"""Noise components (pint_tpu models/noise.py): EFAC/EQUAD scaling,
ECORR as epoch segments, power-law red noise.

Each correlated process splits into a static per-dataset basis and a
weights function of the values.  ``EcorrNoise`` does not build the
dense (N, K_e) 0/1 quantization basis: its prepare emits per-TOA epoch
ids plus the CSR of each epoch's rows (a stable argsort of the ids,
built once on the host), which the segment-sum kernel K2 consumes.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from pint_tpu_torch.linalg import epoch_csr
from pint_tpu_torch.models.component import (Component, as_tensor,
                                             mask_from_select)

#: 1/yr in Hz, the reference's fyr constant
FYR = 1.0 / 3.16e7


def _quantization_buckets(t_s, dt=1.0, nmin=2) -> List[List[int]]:
    """Epochs of TOA times: members within ``dt`` s of a running epoch
    reference (in time order), epochs with < ``nmin`` members dropped."""
    t_s = np.asarray(t_s, dtype=np.float64)
    if t_s.size == 0:
        return []
    isort = np.argsort(t_s)
    bucket_ref = [t_s[isort[0]]]
    bucket_ind = [[isort[0]]]
    for i in isort[1:]:
        if t_s[i] - bucket_ref[-1] < dt:
            bucket_ind[-1].append(i)
        else:
            bucket_ref.append(t_s[i])
            bucket_ind.append([i])
    return [ind for ind in bucket_ind if len(ind) >= nmin]


def create_quantization_matrix(t_s, dt=1.0, nmin=2) -> np.ndarray:
    """Dense (N, n_epochs) 0/1 quantization matrix (pint_tpu
    noise.py:55) — the verification form of the epoch segments."""
    keep = _quantization_buckets(t_s, dt, nmin)
    U = np.zeros((len(np.asarray(t_s)), len(keep)))
    for j, ind in enumerate(keep):
        U[ind, j] = 1.0
    return U


def rednoise_freqs(tspan_s: float, nmodes: int) -> np.ndarray:
    """Interleaved sin/cos sampling frequencies k/T, k=1..nmodes."""
    f = np.linspace(1.0 / tspan_s, nmodes / tspan_s, nmodes)
    out = np.zeros(2 * nmodes)
    out[::2] = f
    out[1::2] = f
    return out


def fourier_basis_from_freqs(t_s, freqs) -> np.ndarray:
    """Fourier design matrix (N, len(freqs)), interleaved sin/cos, on a
    given frequency comb (pint_tpu noise.py:109): the streaming append
    extends a basis on its prepare-time comb with it, and
    :func:`fourier_basis` builds every basis through it, so old rows
    repeat bit for bit."""
    t_s = np.asarray(t_s, dtype=np.float64)
    freqs = np.asarray(freqs, dtype=np.float64)
    F = np.zeros((len(t_s), len(freqs)))
    F[:, ::2] = np.sin(2 * np.pi * t_s[:, None] * freqs[::2])
    F[:, 1::2] = np.cos(2 * np.pi * t_s[:, None] * freqs[1::2])
    return F


def fourier_basis(t_s, nmodes: int, tspan_s=None):
    t_s = np.asarray(t_s, dtype=np.float64)
    T = tspan_s if tspan_s is not None else t_s.max() - t_s.min()
    if not np.isfinite(T) or T <= 0.0:
        T = 86400.0
    freqs = rednoise_freqs(T, nmodes)
    return fourier_basis_from_freqs(t_s, freqs), freqs


def toa_fourier_basis(toas, nmodes: int, tspan_s=None):
    """Fourier basis of a TOA table on the absolute TDB second axis."""
    t = np.asarray(toas.ticks).astype(np.float64) / 2**32
    return fourier_basis(t, nmodes, tspan_s=tspan_s)


def powerlaw(f, amp, gamma):
    """Power-law PSD (GW convention)."""
    return amp**2 / 12.0 / math.pi**2 * FYR ** (gamma - 3) * f ** (-gamma)


def gwb_phi(freqs, amp, gamma, df):
    """Per-mode GWB prior weights [s^2] (pint_tpu gw/common.py:66): the
    power law integrated over one frequency bin."""
    return powerlaw(freqs, amp, gamma) * df


class NoiseComponent(Component):
    introduces_correlated_errors = False

    def scaled_sigma(self, values, batch, ctx, sigma):
        return sigma

    def n_basis(self, ctx) -> int:
        """Columns this component adds to the stacked noise basis."""
        return 0

    def weights(self, values, ctx):
        return None


def _stack_masks(selects, toas, device):
    ms = [mask_from_select(s, toas) for s in selects]
    arr = np.stack(ms, 0) if ms else np.zeros((0, len(toas)), bool)
    return as_tensor(arr, device, dtype=torch.bool)


class ScaleToaError(NoiseComponent):
    """sigma' = EFAC * sqrt(sigma^2 + EQUAD^2) per mask (pint_tpu
    noise.py:165-245); a TNEQ duplicated by an EQUAD select is inert."""

    category = "scale_toa_error"

    def __init__(self, efac_selects=(), equad_selects=(), tneq_selects=()):
        super().__init__()
        self.efac_selects = tuple(tuple(s) for s in efac_selects)
        self.equad_selects = tuple(tuple(s) for s in equad_selects)
        self.tneq_selects = tuple(tuple(s) for s in tneq_selects)
        self.tneq_active = tuple(
            s not in self.equad_selects for s in self.tneq_selects)
        self.params = (
            [f"EFAC{i}" for i in range(1, len(self.efac_selects) + 1)]
            + [f"EQUAD{i}" for i in range(1, len(self.equad_selects) + 1)]
            + [f"TNEQ{i}" for i in range(1, len(self.tneq_selects) + 1)])

    def defaults(self):
        d = {f"EFAC{i}": 1.0 for i in range(1, len(self.efac_selects) + 1)}
        d.update({f"EQUAD{i}": 0.0
                  for i in range(1, len(self.equad_selects) + 1)})
        d.update({f"TNEQ{i}": -np.inf
                  for i in range(1, len(self.tneq_selects) + 1)})
        return d

    def prepare(self, toas, model, device):
        return {
            "efac_masks": _stack_masks(self.efac_selects, toas, device),
            "equad_masks": _stack_masks(self.equad_selects, toas, device),
            "tneq_masks": _stack_masks(self.tneq_selects, toas, device),
        }

    def scaled_sigma(self, values, batch, ctx, sigma):
        s2 = sigma**2
        for i in range(1, len(self.equad_selects) + 1):
            q = values[f"EQUAD{i}"]
            s2 = s2 + ctx["equad_masks"][i - 1] * q**2
        for i in range(1, len(self.tneq_selects) + 1):
            if not self.tneq_active[i - 1]:
                continue
            q = 10.0 ** values[f"TNEQ{i}"]
            s2 = s2 + ctx["tneq_masks"][i - 1] * q**2
        sigma = torch.sqrt(s2)
        for i in range(1, len(self.efac_selects) + 1):
            f = values[f"EFAC{i}"]
            sigma = torch.where(ctx["efac_masks"][i - 1], sigma * f, sigma)
        return sigma


class EcorrNoise(NoiseComponent):
    """Epoch-correlated white noise with weights ECORR^2 (pint_tpu
    noise.py:304-418), carried as epoch segments.

    ctx: ``seg`` (N,) int32 epoch id (K_e = no epoch), ``perm``/
    ``offsets`` the int32 CSR of each epoch's rows, ``counts`` the epoch
    count per select.  Epoch ids run select by select, time-ordered
    inside a select — the column order of the reference's dense basis."""

    category = "ecorr_noise"
    introduces_correlated_errors = True

    def __init__(self, selects=()):
        super().__init__()
        self.selects = tuple(tuple(s) for s in selects)
        self.params = [f"ECORR{i}" for i in range(1, len(self.selects) + 1)]

    def defaults(self):
        return {p: 0.0 for p in self.params}

    def prepare(self, toas, model, device):
        t = np.asarray(toas.ticks).astype(np.float64) / 2**32
        n = len(toas)
        # pad sentinels and quarantined rows never seed or join epochs
        live = ~(toas.flag_equals("pad", "1")
                 | toas.flag_equals("quarantine", "1"))
        seg = np.full(n, -1, dtype=np.int64)
        counts = []
        k = 0
        for sel in self.selects:
            rows = np.flatnonzero(mask_from_select(sel, toas) & live)
            buckets = _quantization_buckets(t[rows])
            for j, ind in enumerate(buckets):
                hit = rows[np.asarray(ind)]
                if np.any(seg[hit] >= 0):
                    raise NotImplementedError(
                        "overlapping ECORR epochs: the dense-basis "
                        "fallback is not ported (ROADMAP queue 1 item 3)")
                seg[hit] = k + j
            k += len(buckets)
            counts.append(len(buckets))
        seg[seg < 0] = k
        perm, offsets = epoch_csr(seg, k)
        return {
            "seg": as_tensor(seg, device, dtype=torch.int32),
            "perm": as_tensor(perm, device, dtype=torch.int32),
            "offsets": as_tensor(offsets, device, dtype=torch.int32),
            "counts": tuple(counts),
        }

    def prepare_streamed(self, toas, model, old_ctx, n0, n1, device):
        """The ctx after rows ``[n0, n1)`` of ``toas`` were appended
        (pint_tpu noise.py:363): the old epoch layout when the new rows
        cannot disturb it, None (a full re-prepare) otherwise.  Epochs
        key on their first time with a running 1 s window, so rows later
        than every old row by more than the window can neither re-bucket
        an old row nor revive a dropped singleton; they matter only if
        they form an epoch of >= 2 among themselves.  Vetoes: new rows
        out of time order, a new row within 1 s of the last old live row
        of its select, a new epoch.  On the fast path every new row is a
        singleton, outside every epoch, as a from-scratch prepare would
        leave it."""
        t = np.asarray(toas.ticks).astype(np.float64) / 2**32
        live = ~(toas.flag_equals("pad", "1")
                 | toas.flag_equals("quarantine", "1"))
        for sel in self.selects:
            mask = mask_from_select(sel, toas) & live
            t_old = t[:n0][mask[:n0]]
            t_new = t[n0:n1][mask[n0:n1]]
            if t_new.size == 0:
                continue
            if np.any(np.diff(t_new) < 0.0):
                return None
            if t_old.size and float(t_new.min()) < float(t_old.max()) + 1.0:
                return None
            if _quantization_buckets(t_new):
                return None
        return dict(old_ctx)

    def n_basis(self, ctx) -> int:
        return int(sum(ctx["counts"]))

    def weights(self, values, ctx):
        parts = [
            values[f"ECORR{i}"] ** 2 * torch.ones(
                c, dtype=torch.float64, device=ctx["seg"].device)
            for i, c in enumerate(ctx["counts"], start=1)
        ]
        if not parts:
            return torch.zeros(0, dtype=torch.float64,
                               device=ctx["seg"].device)
        return torch.cat(parts)


class PLRedNoise(NoiseComponent):
    """Achromatic power-law red noise (pint_tpu noise.py:419-476,
    :636): TNRED{AMP,GAM,C}, or RNAMP/RNIDX (tempo convention)."""

    category = "pl_red_noise"
    introduces_correlated_errors = True
    pl_params = ("TNREDAMP", "TNREDGAM", "TNREDC", 30)

    def __init__(self, use_rn=False):
        super().__init__()
        self.use_rn = bool(use_rn)
        self.params = ["TNREDAMP", "TNREDGAM", "TNREDC", "RNAMP", "RNIDX"]

    def defaults(self):
        return {p: np.nan for p in self.params}

    def _nmodes(self, model):
        v = model.values.get(self.pl_params[2], np.nan)
        return int(v) if np.isfinite(v) and v > 0 else self.pl_params[3]

    def prepare(self, toas, model, device):
        F, freqs = toa_fourier_basis(toas, self._nmodes(model))
        return {"basis": as_tensor(F, device),
                "freqs": as_tensor(freqs, device), "df": float(freqs[0])}

    def prepare_streamed(self, toas, model, old_ctx, n0, n1, device):
        """The ctx after rows ``[n0, n1)`` of ``toas`` were appended
        (pint_tpu noise.py:441): the basis extended on the FROZEN
        prepare-time frequency comb, not the new span, so the old rows
        keep their bits and only the new rows are computed (host numpy
        on the ticks, as the reference does) and written on the device.
        Rows past ``n1`` keep the old pad values (weight ~1e-44).  None
        when the mode count changed."""
        freqs = old_ctx["freqs"].cpu().numpy()
        if freqs.shape[0] != 2 * self._nmodes(model):
            return None
        t = np.asarray(toas.ticks[n0:n1]).astype(np.float64) / 2**32
        F = old_ctx["basis"].clone()
        F[n0:n1] = as_tensor(fourier_basis_from_freqs(t, freqs), device)
        return {"basis": F, "freqs": old_ctx["freqs"], "df": old_ctx["df"]}

    def n_basis(self, ctx) -> int:
        return int(ctx["basis"].shape[1])

    def _amp_gam(self, values):
        if self.use_rn:
            fac = (86400.0 * 365.24 * 1e6) / (2.0 * np.pi * np.sqrt(3.0))
            return values["RNAMP"] / fac, -values["RNIDX"]
        return 10.0 ** values["TNREDAMP"], values["TNREDGAM"]

    def weights(self, values, ctx):
        amp, gam = self._amp_gam(values)
        return powerlaw(ctx["freqs"], amp, gam) * ctx["df"]
