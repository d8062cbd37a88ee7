"""Pair-wise optimal statistic of a GW background (pint_tpu gw/os.py).

Over every pulsar pair (a, b), with ``z_a = F_a^T C_a^-1 r_a``,
``M_a = F_a^T C_a^-1 F_a`` and the unit-amplitude template ``phihat``:

    num_ab = z_a^T phihat z_b,   den_ab = tr[phihat M_a phihat M_b],
    rho_ab = num_ab / den_ab,    sigma_ab = den_ab^-1/2,
    Ahat^2 = sum Gamma_ab num_ab / sum Gamma_ab^2 den_ab,
    S/N    = sum Gamma_ab num_ab / sqrt(sum Gamma_ab^2 den_ab).

Where the reference whitens each pulsar through an (n, m2) C^-1 F
(``_zm_one``), the port takes z and M from the per-pulsar grams of
kernel K3 and the capacity Cholesky (:func:`pint_tpu_torch.linalg.
kron_pulsar_terms`): ``z = b_f - g_uf^T cap^-1 b_u``, ``M = g_ff -
g_uf^T cap^-1 g_uf``, the same algebra.  The grams do not depend on the
noise weights, so a noise-marginalized draw costs one batched capacity
Cholesky and one launch of the pair kernel K4 (``csrc/os_pairs.cu``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch._cuda import CudaKernel
from pint_tpu_torch.gw.common import (CommonProcess, build_pulsar_data,
                                      kron_data, red_noise_layout)
from pint_tpu_torch.gw.orf import orf_matrix, pair_indices
from pint_tpu_torch.linalg import kron_pulsar_terms
from pint_tpu_torch.models.noise import gwb_phi, powerlaw

#: the SMBHB background's spectral index, the default template
GWB_GAMMA = 13.0 / 3.0

#: kernel K4 (replaces pint_tpu gw/os.py:86 _pair_num_den)
K4 = CudaKernel("os_pair_stage", "os_pairs.cu", "os_pairs_launch",
                [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2)


class OSResult(NamedTuple):
    """One optimal-statistic evaluation over the whole array."""

    ahat2: float
    snr: float
    sigma_ahat2: float
    rho: np.ndarray       # (n_pairs,)
    sig: np.ndarray       # (n_pairs,)
    pairs: np.ndarray     # (n_pairs, 2)
    orf_vals: np.ndarray  # (n_pairs,)

    @property
    def ahat(self):
        return float(np.sqrt(self.ahat2)) if self.ahat2 > 0 else float("nan")


# --------------------------------------------------------------------------
# the pair stage (kernel K4 and its plain version)
# --------------------------------------------------------------------------

def os_pairs_plain(z, M, phihat, ii, jj):
    """(num, den) over the pairs (ii, jj): the plain PyTorch version of
    K4, with the reference's product order."""
    num = torch.sum(z[ii] * (phihat * z[jj]), dim=-1)
    pm = phihat[:, None] * M * phihat[None, :]
    den = torch.sum(pm[ii] * M[jj].transpose(-1, -2), dim=(-2, -1))
    return num, den


def os_pairs_cuda(z, M, phihat):
    """Kernel K4 on CUDA tensors: (num, den) (P (P - 1) / 2,) over every
    pair a < b in :func:`~pint_tpu_torch.gw.orf.pair_indices` order, the
    row-major upper triangle; raises on what it does not take."""
    dev = z.device
    if dev.type != "cuda" or any(x.device != dev for x in (M, phihat)):
        raise ValueError("os_pairs_cuda: inputs must be on one CUDA device")
    if any(x.dtype != torch.float64 for x in (z, M, phihat)):
        raise ValueError("os_pairs_cuda: z, M, phihat must be float64")
    p, m2 = z.shape
    if M.shape != (p, m2, m2) or phihat.shape != (m2,):
        raise ValueError("os_pairs_cuda: shapes z (P, m2), M (P, m2, m2), "
                         "phihat (m2,)")
    if p * m2 * m2 >= 2**31 or p * p >= 2**31:
        raise ValueError("os_pairs_cuda: P m2^2 and P^2 must stay under "
                         "2^31")
    z, M, phihat = z.contiguous(), M.contiguous(), phihat.contiguous()
    n_pairs = p * (p - 1) // 2
    num = torch.empty(n_pairs, dtype=torch.float64, device=dev)
    den = torch.empty(n_pairs, dtype=torch.float64, device=dev)
    if n_pairs:
        K4.launch(dev, z.data_ptr(), M.data_ptr(), phihat.data_ptr(),
                  num.data_ptr(), den.data_ptr(), p, m2)
    return num, den


def os_pairs(z, M, phihat):
    """The pair stage over every pair a < b in
    :func:`~pint_tpu_torch.gw.orf.pair_indices` order: K4 for CUDA
    tensors, the plain version for CPU tensors."""
    if z.device.type == "cuda":
        return os_pairs_cuda(z, M, phihat)
    if z.device.type == "cpu":
        ii, jj = torch.triu_indices(z.shape[0], z.shape[0], 1)
        return os_pairs_plain(z, M, phihat, ii, jj)
    raise ValueError(f"os_pairs: no version for {z.device}")


def _os_sums(num, den, gvals):
    """(rho, sig, ahat2, snr, sigma_ahat2) from the pair stage
    (pint_tpu gw/os.py:100-108)."""
    den = torch.clamp(den, min=1e-300)
    snum = torch.sum(gvals * num)
    sden = torch.sum(gvals**2 * den)
    return (num / den, 1.0 / torch.sqrt(den), snum / sden,
            snum / torch.sqrt(sden), 1.0 / torch.sqrt(sden))


class OptimalStatistic:
    """The pair-wise optimal statistic of a pulsar array.

    ``OptimalStatistic(pairs, nmodes=10, gamma=13/3, orf="hd",
    device=None)``, pairs ``[(model, toas, tzr), ...]``; runs on CUDA
    unless ``device`` names another device.  ``marginalize_timing``
    folds each pulsar's normalized timing design into its noise basis
    at effectively infinite prior variance."""

    def __init__(self, pairs, *, nmodes=10, gamma=GWB_GAMMA, orf="hd",
                 tspan_s=None, marginalize_timing=True, device=None):
        self.device = resolve_device(device)
        data, pos, freqs, df, resids = build_pulsar_data(
            pairs, nmodes=nmodes, tspan_s=tspan_s,
            marginalize_timing=marginalize_timing, device=self.device)
        self.data = data
        self.names = [d.name for d in data]
        self.n_pulsars = k = len(data)
        self.nmodes = int(nmodes)
        self.gamma = float(gamma)
        self.pos = pos
        self.orf_kind = orf
        self.orf = orf_matrix(pos, orf)
        self.freqs = np.asarray(freqs)
        self.df = float(df)
        self._prepareds = [r.prepared for r in resids]
        self.kron_data = kron_data(data, self.orf, self.device)
        ii, jj = pair_indices(k)
        self._ii, self._jj = ii, jj
        self.n_pairs = len(ii)
        self._gvals = self.orf[ii, jj]
        self._gvals_t = torch.as_tensor(self._gvals, device=self.device)
        self._phihat = torch.as_tensor(
            gwb_phi(self.freqs, 1.0, self.gamma, self.df),
            device=self.device)

    def common_process(self) -> CommonProcess:
        """A :class:`CommonProcess` over the same per-pulsar data and
        grams (no second build), with the same nmodes and ORF."""
        return CommonProcess(
            nmodes=self.nmodes, orf=self.orf_kind, device=self.device,
            _prebuilt=(self.data, self.pos, self.freqs, self.df,
                       self.kron_data))

    def _statistic(self, phi_noise):
        """(rho, sig, ahat2, snr, sigma_ahat2) tensors at the noise
        weights ``phi_noise`` (P, nb_max)."""
        _, z, M, _ = kron_pulsar_terms(self.kron_data.gram, phi_noise)
        num, den = os_pairs(z, M, self._phihat)
        return _os_sums(num, den, self._gvals_t)

    def compute(self) -> OSResult:
        """The OS over every pair at the build's noise weights."""
        rho, sig, ahat2, snr, sig_a = self._statistic(
            self.kron_data.phi_noise)
        return OSResult(
            ahat2=float(ahat2), snr=float(snr), sigma_ahat2=float(sig_a),
            rho=rho.cpu().numpy(), sig=sig.cpu().numpy(),
            pairs=np.stack([self._ii, self._jj], axis=1),
            orf_vals=np.asarray(self._gvals))

    def _red_noise_layout(self):
        """(mask, freqs, df) of every pulsar's red-noise block
        (:func:`~pint_tpu_torch.gw.common.red_noise_layout`)."""
        mask, freqs, dfs = red_noise_layout(
            self._prepareds, self.kron_data.phi_noise.shape[1], self.device)
        if not bool(mask.any()):
            raise ValueError(
                "noise_marginalized: no pulsar in the array carries a "
                "PLRedNoise component to marginalize over")
        return mask, freqs, dfs

    def noise_marginalized(self, log10_amp_draws, gamma_draws):
        """OS over draws of every pulsar's intrinsic red-noise (log10 A,
        gamma), each (n_draws, n_pulsars) or (n_draws,) broadcast over
        pulsars.  Returns (ahat2, snr, sigma_ahat2), each (n_draws,).
        White noise stays at the build's values."""
        amps = np.asarray(log10_amp_draws, np.float64)
        gams = np.asarray(gamma_draws, np.float64)
        if amps.ndim == 1:
            amps = np.repeat(amps[:, None], self.n_pulsars, axis=1)
        if gams.ndim == 1:
            gams = np.repeat(gams[:, None], self.n_pulsars, axis=1)
        mask, freqs, dfs = self._red_noise_layout()
        amps_t = torch.as_tensor(amps, device=self.device)
        gams_t = torch.as_tensor(gams, device=self.device)
        phi0 = self.kron_data.phi_noise
        out = []
        for d in range(amps.shape[0]):
            pl = powerlaw(freqs, 10.0 ** amps_t[d][:, None],
                          gams_t[d][:, None]) * dfs[:, None]
            _, _, ahat2, snr, sig_a = self._statistic(
                torch.where(mask, pl, phi0))
            out.append(torch.stack([ahat2, snr, sig_a]))
        res = torch.stack(out).cpu().numpy()
        return res[:, 0], res[:, 1], res[:, 2]
