"""Common red process (CRN/GWB) likelihood across a pulsar array
(pint_tpu gw/common.py), kron-structured and dense.

Over the stacked residuals of the array the covariance is

    C = blockdiag_a(diag(sigma_a^2) + U_a diag(phi_a) U_a^T)
        + blockdiag_a(F_a) kron(Gamma, diag(phi_gw)) blockdiag_a(F_a)^T

with U_a each pulsar's own noise basis plus its mean-offset and timing
design columns, F_a the GW Fourier basis at the array's common
frequencies k/T and Gamma the ORF.  The likelihood goes through the
two-level Woodbury of :mod:`pint_tpu_torch.linalg`: per-pulsar grams
(kernel K3 over a ragged stack, built once), a batched per-pulsar
Cholesky, and one (P m2, P m2) LU per (log10 A, gamma) point.

``kron=False`` takes the reference's dense path instead, its oracle for
the kron path: the stacked (N_tot, K) basis U_full, its gram
G0 = U_full^T N^-1 U_full held once, and per point the capacity
G0 + phi^-1 of the dense (K, K) prior (kernel K11 on CUDA), one
Cholesky (cuSOLVER) and one solve.
"""

from __future__ import annotations

import math
import warnings
from typing import List, NamedTuple

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch.fitter import FitDivergedError
from pint_tpu_torch.gw.orf import orf_matrix, pulsar_positions
from pint_tpu_torch.linalg import (KronGram, KronPhi, RaggedStack,
                                   cho_factor, cho_solve, crn_capacity,
                                   kron_chi2_logdet_pre,
                                   kron_gram_precompute, kron_gw_terms,
                                   kron_pulsar_terms, ragged_stack,
                                   su_to_dense)
from pint_tpu_torch.models.noise import gwb_phi, toa_fourier_basis
from pint_tpu_torch.residuals import MEAN_OFFSET_WEIGHT, Residuals

#: pad-row sigma [s] of the reference's padded per-pulsar stacks; the
#: port's ragged stacks have no pad rows, and the tests pad with it to
#: feed the reference
PAD_SIGMA_S = 1e16

#: default device-memory budget of one lnlike_grid chunk [bytes]
GRID_MEM_BYTES = 8 << 30


def common_tspan_s(toas_list) -> float:
    """Array-wide span [s]: the largest minus the smallest TDB tick over
    every pulsar, each extreme converted as float(ticks) / 2^32."""
    lo = min(float(t.ticks.min()) for t in toas_list) / 2**32
    hi = max(float(t.ticks.max()) for t in toas_list) / 2**32
    return hi - lo


class PulsarGWData(NamedTuple):
    """One pulsar's ingredients (host numpy, at the model's values)."""

    r: np.ndarray      # (n,) time residuals [s], weighted mean removed
    sigma: np.ndarray  # (n,) noise-scaled uncertainties [s]
    U: np.ndarray      # (n, nb) own noise basis + offset + timing columns
    phi: np.ndarray    # (nb,) own basis weights [s^2]
    F: np.ndarray      # (n, 2 nmodes) common-frequency GW basis
    name: str


def _timing_design(resid: Residuals) -> torch.Tensor:
    """Column-normalized d(time residual)/d(free timing parameter),
    ``torch.func.jacfwd`` over ``free_timing_params``; a zero column
    keeps norm 1."""
    names = list(resid.model.free_timing_params)
    n = len(resid.toas)
    if not names:
        return torch.zeros((n, 0), dtype=torch.float64, device=resid.device)
    base = resid.prepared.values_dict()

    def f(vec):
        values = dict(base)
        for i, k in enumerate(names):
            values[k] = vec[i]
        return resid.time_resids_at(values)

    vec0 = torch.stack([base[k] for k in names])
    J = torch.func.jacfwd(f)(vec0)
    norm = torch.linalg.norm(J, dim=0)
    return J / torch.where(norm == 0.0, torch.ones_like(norm), norm)


def build_pulsar_data(pairs, *, nmodes=10, tspan_s=None,
                      marginalize_timing=True, device=None):
    """(data, positions (P, 3), freqs (2 nmodes,), df, resids) for
    ``pairs`` = ``[(model, toas, tzr), ...]`` (pint_tpu
    gw/common.py:119).  Residuals and the timing design are computed on
    ``device`` (CUDA unless given) and returned on the host."""
    device = resolve_device(device)
    if len(pairs) < 2:
        raise ValueError(f"a cross-correlation analysis needs >= 2 "
                         f"pulsars, got {len(pairs)}")
    # nearest tracking, as the reference pins it (a TRACK -2 par does
    # not need pulse numbers here)
    resids = [Residuals(t, m, tzr, device=device, track_mode="nearest")
              for m, t, tzr in pairs]
    T = float(tspan_s) if tspan_s else common_tspan_s(
        [r.toas for r in resids])
    pos = pulsar_positions([r.model for r in resids])
    out = []
    freqs = None
    for resid in resids:
        values = resid.prepared.values_dict()
        r = resid.time_resids_at(values).cpu().numpy()
        sigma = resid.sigma_at(values).cpu().numpy()
        # the noise basis without the appended mean-offset column
        U = su_to_dense(resid._U_ext)[:, :-1].cpu().numpy()
        phi = resid.prepared.noise_weights_fn(values).cpu().numpy()
        cols = [U, np.ones((len(r), 1))]
        ws = [phi, np.array([MEAN_OFFSET_WEIGHT])]
        if marginalize_timing:
            J = _timing_design(resid).cpu().numpy()
            cols.append(J)
            ws.append(np.full(J.shape[1], MEAN_OFFSET_WEIGHT))
        F, fgrid = toa_fourier_basis(resid.toas, nmodes, tspan_s=T)
        if freqs is None:
            freqs = fgrid
        out.append(PulsarGWData(
            r=r, sigma=sigma, U=np.concatenate(cols, axis=1),
            phi=np.concatenate(ws), F=F, name=resid.model.name))
    return out, pos, freqs, float(freqs[0]), resids


def red_noise_layout(prepareds, nb_max, device):
    """(mask, freqs, df) tensors locating each pulsar's intrinsic
    red-noise (PLRedNoise) block inside its padded phi row: mask
    (P, nb_max) bool, freqs (P, nb_max) the block's sampling
    frequencies (1 elsewhere), df (P,) its bin width (0 where a pulsar
    has no PLRedNoise)."""
    k = len(prepareds)
    mask = np.zeros((k, nb_max), dtype=bool)
    freqs = np.ones((k, nb_max))
    dfs = np.zeros(k)
    for a, prep in enumerate(prepareds):
        dims = prep.noise_dimensions()
        if "PLRedNoise" not in dims:
            continue
        start, nb = dims["PLRedNoise"]
        ctx = prep.ctx["PLRedNoise"]
        mask[a, start:start + nb] = True
        freqs[a, start:start + nb] = ctx["freqs"].cpu().numpy()[:nb]
        dfs[a] = float(ctx["df"])
    return (torch.as_tensor(mask, device=device),
            torch.as_tensor(freqs, device=device),
            torch.as_tensor(dfs, device=device))


class KronData(NamedTuple):
    """The device side of an array: the ragged stack, its grams (K3,
    built once), the zero-padded noise weights and the ORF."""

    stack: RaggedStack
    gram: KronGram
    phi_noise: torch.Tensor
    orf: torch.Tensor


def padded_phi(data: List[PulsarGWData], device) -> torch.Tensor:
    """(P, nb_max): each pulsar's noise weights, zero-padded to the
    widest pulsar's."""
    phi = np.zeros((len(data), max(len(d.phi) for d in data)))
    for a, d in enumerate(data):
        phi[a, :len(d.phi)] = d.phi
    return torch.as_tensor(phi, device=device)


def kron_data(data: List[PulsarGWData], orf, device) -> KronData:
    """The :class:`KronData` of ``data`` on ``device``; launches K3 once
    on CUDA."""
    st = ragged_stack([d.r for d in data], [d.sigma for d in data],
                      [d.U for d in data], [d.F for d in data], device)
    return KronData(stack=st, gram=kron_gram_precompute(st),
                    phi_noise=padded_phi(data, device),
                    orf=torch.as_tensor(np.asarray(orf, np.float64),
                                        device=device))


class DenseData(NamedTuple):
    """What the dense path holds once: the gram G0 = U_full^T N^-1 U_full
    (K, K), b = U_full^T N^-1 r (K,), r^T N^-1 r, sum log sigma^2, the
    stacked noise weights (kn,), the ORF, and where each noise column's
    weight lies in the flattened (P, nb_max) padded rows (kn,)."""

    gram: torch.Tensor
    b: torch.Tensor
    rr: torch.Tensor
    ld_white: torch.Tensor
    phi_noise: torch.Tensor
    orf: torch.Tensor
    noise_cols: torch.Tensor


def dense_chi2_logdet(dd: DenseData, phi_noise, phi_gw):
    """(chi2 (G,), logdet C (G,)): the reference's dense Woodbury
    (pint_tpu gw/common.py:186 and linalg.py:288) at G points, the dense
    grid's and the dense posterior's: K11's capacity matrices G0 +
    phi_g^-1, then per point one Cholesky and one solve against b,
    chi2 = rr - b^T x and logdet = ld_white + logdet phi + 2 sum log
    diag L.  ``phi_noise`` (kn,) is shared by every point, (G, kn) is a
    row a point; ``phi_gw`` is (G, m2).  Differentiable in both (K11b;
    the Cholesky's and the solve's gradients are PyTorch's).  One point
    at a time: the libraries' batched Cholesky and solve are built for
    small matrices (at K = 6188 the batched solve fails on the card)."""
    S, ld_phi = crn_capacity(dd.gram, phi_noise, dd.orf, phi_gw)
    chi2, ld_cap = [], []
    for s in S:
        L = cho_factor(s)
        x = cho_solve(L, dd.b)
        chi2.append(dd.rr - torch.sum(dd.b * x))
        ld_cap.append(torch.sum(torch.log(torch.diagonal(L))))
    return (torch.stack(chi2),
            dd.ld_white + ld_phi + 2.0 * torch.stack(ld_cap))


class CommonProcess:
    """The PTA likelihood with an ORF-correlated common power-law
    process in (log10 A, gamma); timing parameters marginalized through
    their design columns (``marginalize_timing``).

    ``CommonProcess(pairs, nmodes=10, orf="hd", kron=True, device=None)``,
    pairs ``[(model, toas, tzr), ...]``; runs on CUDA unless ``device``
    names another device.  ``kron=False`` takes the dense path; ``None``
    takes the kron path, as the reference's default gate does.  Each
    path's arrays are built on first use: a dense instance builds no
    kron stacks (no K3), a kron one no U_full."""

    def __init__(self, pairs=None, *, nmodes=10, orf="hd", tspan_s=None,
                 marginalize_timing=True, kron=True, device=None,
                 _prebuilt=None):
        self.device = resolve_device(device)
        if _prebuilt is not None:
            # (data, pos, freqs, df, kron data or None) of a sibling
            data, pos, freqs, df, kd = _prebuilt
            resids = None
        else:
            data, pos, freqs, df, resids = build_pulsar_data(
                pairs, nmodes=nmodes, tspan_s=tspan_s,
                marginalize_timing=marginalize_timing, device=self.device)
            kd = None
        self.data = data
        #: per-pulsar Residuals (their prepared models give the noise
        #: weights as functions of the values); None on the _prebuilt path
        self.resids = resids
        self.names = [d.name for d in data]
        self.n_pulsars = len(data)
        self.nmodes = int(nmodes)
        self.pos = pos
        self.orf_kind = orf
        self.orf = orf_matrix(pos, orf)
        self.freqs = torch.as_tensor(freqs, dtype=torch.float64,
                                     device=self.device)
        self.df = float(df)
        self.n_toa_total = int(sum(len(d.r) for d in data))
        # None is the reference's default gate, which takes the kron path
        self.kron = kron is None or bool(kron)
        self._kron_data = kd
        self._pulsar_terms = None
        self._U_full = None
        self._dense = None
        self._phi_padded = None

    @property
    def kron_data(self) -> KronData:
        """The kron path's ragged stack and grams (K3 on CUDA), built on
        first use."""
        if self._kron_data is None:
            self._kron_data = kron_data(self.data, self.orf, self.device)
        return self._kron_data

    @property
    def U_full(self) -> torch.Tensor:
        """The dense stacked (N_tot, K) basis on the device, built on
        first use: each pulsar's own columns block-diagonal, then its GW
        Fourier columns at ``kn + a m2`` (pint_tpu gw/common.py:335)."""
        if self._U_full is None:
            kn = sum(d.U.shape[1] for d in self.data)
            m2 = 2 * self.nmodes
            U = torch.zeros((self.n_toa_total, kn + self.n_pulsars * m2),
                            dtype=torch.float64, device=self.device)
            row = col = 0
            for a, d in enumerate(self.data):
                n, nb = d.U.shape
                U[row:row + n, col:col + nb] = torch.as_tensor(d.U)
                U[row:row + n, kn + a * m2:kn + (a + 1) * m2] = \
                    torch.as_tensor(d.F)
                row += n
                col += nb
            self._U_full = U
        return self._U_full

    @property
    def dense(self) -> DenseData:
        """The dense path's :class:`DenseData`, formed once (one matmul
        for the gram, as the reference leaves it to XLA)."""
        if self._dense is None:
            def cat(name):
                return torch.as_tensor(np.concatenate(
                    [getattr(d, name) for d in self.data]),
                    device=self.device)
            r, nvec = cat("r"), cat("sigma") ** 2
            U = self.U_full
            ninv_r = r / nvec
            nb_max = max(len(d.phi) for d in self.data)
            cols = np.concatenate([a * nb_max + np.arange(len(d.phi))
                                   for a, d in enumerate(self.data)])
            self._dense = DenseData(
                gram=(U.T * (1.0 / nvec)[None, :]) @ U, b=U.T @ ninv_r,
                rr=torch.sum(r * ninv_r), ld_white=torch.sum(torch.log(nvec)),
                phi_noise=cat("phi"),
                orf=torch.as_tensor(np.asarray(self.orf, np.float64),
                                    device=self.device),
                noise_cols=torch.as_tensor(cols, device=self.device))
        return self._dense

    @property
    def phi_padded(self) -> torch.Tensor:
        """(P, nb_max): each pulsar's noise weights, zero-padded to the
        widest pulsar's (the kron path's layout, which
        :meth:`chi2_logdet` takes on either path)."""
        if self._phi_padded is None:
            self._phi_padded = padded_phi(self.data, self.device)
        return self._phi_padded

    def dense_noise(self, phi_noise):
        """(..., kn): padded noise-weight rows (..., P, nb_max) on the
        dense path's columns (each pulsar's weights, concatenated)."""
        lead = phi_noise.shape[:-2]
        return phi_noise.reshape(lead + (-1,))[..., self.dense.noise_cols]

    def chi2_logdet(self, phi_noise, phi_gw):
        """(chi2 (...), logdet C (...)) with the noise weights and the GW
        powers of each point: ``phi_noise`` (..., P, nb_max) padded rows,
        ``phi_gw`` (..., m2).  The kron path's two-level Woodbury against
        the grams held once (K5 / K5b), or the dense path's
        :func:`dense_chi2_logdet` (K11 / K11b); differentiable in both."""
        if self.kron:
            kd = self.kron_data
            return kron_chi2_logdet_pre(kd.gram, KronPhi(
                orf=kd.orf, phi_gw=phi_gw, phi_noise=phi_noise))
        lead = phi_gw.shape[:-1]
        pn = self.dense_noise(phi_noise)
        chi2, logdet = dense_chi2_logdet(
            self.dense, pn.reshape(-1, pn.shape[-1]),
            phi_gw.reshape(-1, phi_gw.shape[-1]))
        return chi2.reshape(lead), logdet.reshape(lead)

    @property
    def pulsar_terms(self):
        """(chi2_a, x_a, m_a, ld_a): the per-pulsar reduction, fixed
        while the noise weights are, so shared by every GW point."""
        if self._pulsar_terms is None:
            self._pulsar_terms = kron_pulsar_terms(
                self.kron_data.gram, self.kron_data.phi_noise)
        return self._pulsar_terms

    def _phi_gw(self, log10_amps, gammas):
        return gwb_phi(self.freqs, 10.0 ** log10_amps[:, None],
                       gammas[:, None], self.df)

    def _chi2_logdet_kron(self, log10_amps, gammas):
        chi2_d, x, m, ld_d = self.pulsar_terms
        kp = KronPhi(orf=self.kron_data.orf,
                     phi_gw=self._phi_gw(log10_amps, gammas),
                     phi_noise=self.kron_data.phi_noise)
        corr, ld_t = kron_gw_terms(x, m, kp)
        return torch.sum(chi2_d) - corr, torch.sum(ld_d) + ld_t

    def _chi2_logdet_dense(self, log10_amps, gammas):
        dd = self.dense
        return dense_chi2_logdet(dd, dd.phi_noise,
                                 self._phi_gw(log10_amps, gammas))

    def _lnlike_points(self, log10_amps, gammas):
        """(n,) log-likelihoods at n (log10 A, gamma) points (tensors)."""
        chi2, logdet = (self._chi2_logdet_kron if self.kron
                        else self._chi2_logdet_dense)(log10_amps, gammas)
        return (-0.5 * (chi2 + logdet)
                - 0.5 * self.n_toa_total * math.log(2.0 * math.pi))

    def lnlike(self, log10_amp, gamma, check=True) -> float:
        """Log-likelihood at one (log10 A, gamma).  ``check``: a
        non-finite value raises :class:`FitDivergedError`."""
        pt = torch.tensor([[log10_amp, gamma]], dtype=torch.float64,
                          device=self.device)
        out = float(self._lnlike_points(pt[:, 0], pt[:, 1])[0])
        if check and not np.isfinite(out):
            raise FitDivergedError(
                f"gw.common.lnlike({log10_amp}, {gamma}) non-finite")
        return out

    def grid_chunk(self) -> int:
        """Grid points per device batch under :data:`GRID_MEM_BYTES`: each
        point is counted twice (kron: the (P m2)^2 matrix and its LU;
        dense: the (K, K) capacity and its Cholesky factor, one factor
        alive at a time) plus a third copy's headroom."""
        if self.kron:
            n = self.n_pulsars * 2 * self.nmodes
        else:
            n = sum(d.U.shape[1] for d in self.data) \
                + self.n_pulsars * 2 * self.nmodes
        return max(1, GRID_MEM_BYTES // (3 * n * n * 8))

    def lnlike_grid(self, log10_amps, gammas):
        """(A, G) log-likelihood surface over the outer product of the
        two 1-d grids, in batches of :meth:`grid_chunk` points.
        Non-finite points are counted on the device and warned about
        after one host read."""
        a = np.atleast_1d(np.asarray(log10_amps, np.float64))
        g = np.atleast_1d(np.asarray(gammas, np.float64))
        aa, gg = np.meshgrid(a, g, indexing="ij")
        pts_a = torch.as_tensor(aa.ravel(), device=self.device)
        pts_g = torch.as_tensor(gg.ravel(), device=self.device)
        chunk = self.grid_chunk()
        parts = []
        n_bad = torch.zeros((), dtype=torch.int64, device=self.device)
        for s in range(0, aa.size, chunk):
            out = self._lnlike_points(pts_a[s:s + chunk],
                                      pts_g[s:s + chunk])
            n_bad += torch.sum(~torch.isfinite(out))
            parts.append(out)
        surf = torch.cat(parts).cpu().numpy().reshape(aa.shape)
        n_bad = int(n_bad)
        if n_bad:
            warnings.warn(f"lnlike_grid: {n_bad}/{surf.size} non-finite "
                          "grid points (degenerate prior or corrupted "
                          "inputs)")
        return surf
