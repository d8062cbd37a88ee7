"""Linear algebra of correlated-noise likelihoods, the port of
``pint_tpu.linalg`` (the single-pulsar Woodbury and GLS core).

The covariance is C = N + U Phi U^T with N diagonal; everything goes
through the rank-K capacity matrix Sigma = Phi^-1 + U^T N^-1 U, so
nothing O(N^2) is formed.

``U`` is a dense (N, K) tensor or a :class:`StructuredU`, whose ECORR
epoch-indicator block is carried as per-TOA segment ids plus a CSR of
each epoch's rows.  The epoch block's products are segment sums, done on
CUDA by kernel K2 (``csrc/segment_sum.cu``, one thread per (segment,
column), rows added in ascending order: deterministic, unlike
``index_add_`` with atomics) and on the CPU by the plain version
:func:`segment_sum_plain`.

Where pint_tpu and PyTorch part ways:

- ``jax.scipy.linalg.cho_factor`` returns NaN on a failed
  factorization; ``torch.linalg.cholesky`` raises.  :func:`cho_factor`
  uses ``cholesky_ex`` and turns a failure into NaN, without a host
  sync, so the NaN propagates as it does in the reference.
- ``gls_normal_solve`` keeps the eigh pseudo-inverse with its
  1e-16 * lambda_max cutoff; :class:`SolveDiag` reports how many
  directions the cutoff dropped.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from pint_tpu_torch._cuda import CudaKernel

#: floor on basis weights (pint_tpu linalg._PHI_FLOOR): a zero weight
#: pins its coefficient instead of producing 1/0.  Kept although IEEE
#: f64 would not need it: it changes the answer.
_PHI_FLOOR = 1e-30

#: kernel K2 (replaces the jax.ops.segment_sum calls of pint_tpu
#: linalg.py:158 _ut_dot and :191 _weighted_gram)
K2 = CudaKernel(
    "segment_sum_fixed_order", "segment_sum.cu", "segment_sum_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int64, ctypes.c_int64])


class SolveDiag(NamedTuple):
    """Spectrum diagnostics of one normal-equation solve (pint_tpu
    guard.SolveDiag)."""

    n_truncated: torch.Tensor  #: eigenvalues zeroed by the cutoff
    cond_log10: torch.Tensor   #: log10(max / smallest kept eigenvalue)


# --------------------------------------------------------------------------
# segment sums (kernel K2 and its plain version)
# --------------------------------------------------------------------------

def segment_sum_plain(x, perm, offsets):
    """(K_e, M) sums of the rows of ``x`` (N, M) over each segment of the
    CSR (perm, offsets), rows added in ascending order from zero — the
    plain PyTorch version of kernel K2 (CPU ``index_add_`` adds rows in
    index order)."""
    k_e = offsets.numel() - 1
    counts = (offsets[1:] - offsets[:-1]).to(torch.int64)
    seg_of = torch.repeat_interleave(
        torch.arange(k_e, device=x.device), counts)
    out = torch.zeros((k_e, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg_of, x[perm.to(torch.int64)])


def segment_sum_cuda(x, perm, offsets):
    """Kernel K2 on CUDA tensors; raises on what it does not take."""
    dev = x.device
    if dev.type != "cuda" or perm.device != dev or offsets.device != dev:
        raise ValueError("segment_sum_cuda: x, perm and offsets must be on "
                         "one CUDA device")
    if x.dtype != torch.float64 or x.dim() != 2:
        raise ValueError("segment_sum_cuda: x must be a 2-D float64 tensor")
    if perm.dtype != torch.int32 or offsets.dtype != torch.int32 \
            or perm.dim() != 1 or offsets.dim() != 1:
        raise ValueError("segment_sum_cuda: perm and offsets must be 1-D "
                         "int32")
    if perm.numel() > x.shape[0]:
        raise ValueError("segment_sum_cuda: perm longer than x")
    x = x.contiguous()
    k_e = offsets.numel() - 1
    m = x.shape[1]
    out = torch.empty((k_e, m), dtype=torch.float64, device=dev)
    if k_e * m:
        K2.launch(dev, x.data_ptr(), perm.contiguous().data_ptr(),
                  offsets.contiguous().data_ptr(), out.data_ptr(), k_e, m)
    return out


def segment_sum_fixed_order(x, perm, offsets):
    """Segment sums of ``x`` ((N,) or (N, M)) in a fixed order: K2 for
    CUDA tensors, the plain version for CPU tensors."""
    vec = x.dim() == 1
    x2 = x[:, None] if vec else x
    if x2.device.type == "cuda":
        out = segment_sum_cuda(x2, perm, offsets)
    elif x2.device.type == "cpu":
        out = segment_sum_plain(x2, perm, offsets)
    else:
        raise ValueError(f"segment_sum_fixed_order: no version for "
                         f"{x2.device}")
    return out[:, 0] if vec else out


# --------------------------------------------------------------------------
# structured basis
# --------------------------------------------------------------------------

@dataclass
class StructuredU:
    """Woodbury basis ``[pre | ECORR epochs | post]`` with the epoch
    block carried as segment ids (the same column order as the dense
    basis it replaces).

    seg: (N,) int32 epoch id, ``k_e`` for rows outside every epoch;
    perm: int32 rows of all epochs, epoch by epoch, ascending inside an
    epoch (stable argsort of seg); offsets: (k_e+1,) int32 CSR bounds."""

    pre: torch.Tensor
    seg: torch.Tensor
    perm: torch.Tensor
    offsets: torch.Tensor
    post: torch.Tensor

    @property
    def k_e(self) -> int:
        return int(self.offsets.numel()) - 1


def basis_ncols(U) -> int:
    if isinstance(U, StructuredU):
        return U.pre.shape[1] + U.k_e + U.post.shape[1]
    return U.shape[1]


def epoch_csr(seg, k_e):
    """(perm, offsets) int32 CSR of the segment ids ``seg`` (numpy,
    host-side, built once): a stable argsort keeps each epoch's rows in
    ascending order."""
    seg = np.asarray(seg, dtype=np.int64)
    order = np.argsort(seg, kind="stable")
    perm = order[seg[order] < k_e]
    counts = np.bincount(seg[seg < k_e], minlength=k_e)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return perm.astype(np.int32), offsets.astype(np.int32)


def structured_from_blocks(pre, seg, k_e, post, device):
    """StructuredU from host blocks (numpy), placed on ``device``."""
    perm, offsets = epoch_csr(seg, k_e)
    return StructuredU(
        pre=torch.as_tensor(np.asarray(pre, np.float64), device=device),
        seg=torch.as_tensor(np.asarray(seg, np.int32), device=device),
        perm=torch.as_tensor(perm, device=device),
        offsets=torch.as_tensor(offsets, device=device),
        post=torch.as_tensor(np.asarray(post, np.float64), device=device),
    )


def su_to_dense(su: StructuredU):
    """The dense (N, K) basis — the verification form."""
    ar = torch.arange(su.k_e, device=su.seg.device)
    ecorr = (su.seg.to(torch.int64)[:, None] == ar[None, :]).to(
        torch.float64)
    return torch.cat([su.pre, ecorr, su.post], dim=1)


def _ut_dot(U, y):
    """``U^T @ y`` for dense or structured U; y is (N,) or (N, M)."""
    if not isinstance(U, StructuredU):
        return U.T @ y
    seg_part = segment_sum_fixed_order(y, U.perm, U.offsets)
    return torch.cat([U.pre.T @ y, seg_part, U.post.T @ y], dim=0)


def _u_dot(U, x):
    """``U @ x`` for dense or structured U; x is (K,) or (K, M).  The
    epoch block is a gather (rows outside every epoch gather zero)."""
    if not isinstance(U, StructuredU):
        return U @ x
    k_pre = U.pre.shape[1]
    k_e = U.k_e
    x_e = x[k_pre:k_pre + k_e]
    x_e_ext = torch.cat(
        [x_e, torch.zeros((1,) + tuple(x_e.shape[1:]), dtype=x.dtype,
                          device=x.device)], dim=0)
    return (U.pre @ x[:k_pre] + x_e_ext[U.seg.to(torch.int64)]
            + U.post @ x[k_pre + k_e:])


def _weighted_gram(U, w):
    """``U^T diag(w) U`` for dense or structured U.  Structured: the
    epoch block's products are segment sums — of w (the diagonal block)
    and of the weighted dense columns (the cross blocks)."""
    if not isinstance(U, StructuredU):
        return (U.T * w[None, :]) @ U
    pre_w = U.pre * w[:, None]
    post_w = U.post * w[:, None]
    g_pp = U.pre.T @ pre_w
    g_p_post = U.pre.T @ post_w
    g_post_post = U.post.T @ post_w
    g_pe = segment_sum_fixed_order(pre_w, U.perm, U.offsets).T
    g_e_post = segment_sum_fixed_order(post_w, U.perm, U.offsets)
    g_ee = torch.diag(segment_sum_fixed_order(w, U.perm, U.offsets))
    return torch.cat([
        torch.cat([g_pp, g_pe, g_p_post], dim=1),
        torch.cat([g_pe.T, g_ee, g_e_post], dim=1),
        torch.cat([g_p_post.T, g_e_post.T, g_post_post], dim=1),
    ], dim=0)


# --------------------------------------------------------------------------
# Cholesky with the reference's failure semantics
# --------------------------------------------------------------------------

def cho_factor(a):
    """Lower Cholesky factor; NaN-filled when the factorization fails
    (``jax.scipy.linalg.cho_factor`` semantics), with no host sync."""
    L, info = torch.linalg.cholesky_ex(a)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def cho_solve(L, b):
    """Solve (L L^T) x = b for b (K,) or (K, M)."""
    if b.dim() == 1:
        return torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.cholesky_solve(b, L)


# --------------------------------------------------------------------------
# Woodbury
# --------------------------------------------------------------------------

def _phi_terms(phi):
    """(phi_inv (K, K), logdet_phi) for a (K,) weight vector, the
    diagonal floored at ``_PHI_FLOOR``."""
    phi = torch.clamp(phi, min=_PHI_FLOOR)
    return torch.diag(1.0 / phi), torch.sum(torch.log(phi))


def _capacity(sigma, U, phi):
    """(nvec, L, logdet_phi): the Cholesky of the capacity matrix
    U^T N^-1 U + Phi^-1 every Woodbury path shares."""
    phi_inv, logdet_phi = _phi_terms(phi)
    nvec = sigma**2
    sigma_cap = _weighted_gram(U, 1.0 / nvec) + phi_inv
    return nvec, cho_factor(sigma_cap), logdet_phi


def woodbury_chi2_logdet(r, sigma, U, phi):
    """(chi2, logdet C) for C = diag(sigma^2) + U diag(phi) U^T, by the
    Woodbury identity and the matrix determinant lemma."""
    nvec, L, logdet_phi = _capacity(sigma, U, phi)
    ninv_r = r / nvec
    ut_ninv_r = _ut_dot(U, ninv_r)
    x = cho_solve(L, ut_ninv_r)
    chi2 = torch.sum(r * ninv_r) - torch.sum(ut_ninv_r * x)
    logdet = (torch.sum(torch.log(nvec)) + logdet_phi
              + 2.0 * torch.sum(torch.log(torch.diagonal(L))))
    return chi2, logdet


def noise_gram_precompute(sigma, U, phi):
    """The constant (K, K) block of the GLS normal matrix,
    ``U^T diag(sigma^-2) U + Phi^-1`` (built once per fit when no free
    parameter touches the noise model)."""
    phi_inv, _ = _phi_terms(phi)
    return _weighted_gram(U, 1.0 / sigma**2) + phi_inv


def gls_normal_solve(r, J, sigma, U, phi, gram: Optional[torch.Tensor] = None,
                     with_health=False):
    """Solve the noise-augmented GLS normal equations: minimize
    (r - J d - U a)^T N^-1 (r - J d - U a) + a^T Phi^-1 a over (d, a).

    Returns (dpar, cov, noise_coeffs, chi2[, SolveDiag]): dpar is the
    step to ADD to the parameter vector (J = d resid / d param), cov the
    parameter covariance, noise_coeffs the basis amplitudes, chi2 the
    Woodbury chi^2 of r.  Three branches, as in pint_tpu: ``gram`` (the
    precomputed noise block — only the J-dependent blocks are built),
    structured U without a gram, and dense U."""
    n_par = J.shape[1]
    nb = basis_ncols(U)
    nvec = sigma**2
    w = 1.0 / nvec
    if gram is not None and nb:
        Jw = J * w[:, None]
        a_jj = J.T @ Jw
        a_ju = _ut_dot(U, Jw).T
        mtcm = torch.cat([torch.cat([a_jj, a_ju], dim=1),
                          torch.cat([a_ju.T, gram], dim=1)], dim=0)
        rhs = torch.cat([Jw.T @ r, _ut_dot(U, w * r)])
    elif isinstance(U, StructuredU):
        Jw = J * w[:, None]
        a_jj = J.T @ Jw
        a_ju = _ut_dot(U, Jw).T
        a_uu = _weighted_gram(U, w)
        phi_inv, _ = _phi_terms(phi)
        mtcm = torch.cat([torch.cat([a_jj, a_ju], dim=1),
                          torch.cat([a_ju.T, a_uu + phi_inv], dim=1)],
                         dim=0)
        rhs = torch.cat([Jw.T @ r, _ut_dot(U, w * r)])
    else:
        M = torch.cat([J, U], dim=1) if nb else J
        mtn = (M * w[:, None]).T
        mtcm = mtn @ M
        if nb:
            phi_inv, _ = _phi_terms(phi)
            mtcm = mtcm + torch.block_diag(
                torch.zeros((n_par, n_par), dtype=mtcm.dtype,
                            device=mtcm.device), phi_inv)
        rhs = mtn @ r
    # column normalization for conditioning
    norm = torch.sqrt(torch.diagonal(mtcm))
    norm = torch.where(norm == 0, torch.ones_like(norm), norm)
    mtcm_n = mtcm / torch.outer(norm, norm)
    # eigh with a pseudo-inverse cutoff (pint_tpu keeps this over
    # Cholesky; the port keeps it so truncation matches the reference)
    ev, Q = torch.linalg.eigh(mtcm_n)
    evmax = torch.max(ev)
    keep = ev > 1e-16 * evmax
    ev_inv = torch.where(keep, 1.0 / ev, torch.zeros_like(ev))
    xhat = (Q @ (ev_inv * (Q.T @ (rhs / norm)))) / norm
    cov_full = (Q * ev_inv[None, :]) @ Q.T / torch.outer(norm, norm)
    if nb:
        if gram is not None:
            # the precomputed gram IS the Woodbury capacity matrix
            L = cho_factor(gram)
            ninv_r = r / nvec
            ut_ninv_r = _ut_dot(U, ninv_r)
            x = cho_solve(L, ut_ninv_r)
            chi2 = torch.sum(r * ninv_r) - torch.sum(ut_ninv_r * x)
        else:
            chi2, _ = woodbury_chi2_logdet(r, sigma, U, phi)
    else:
        chi2 = torch.sum((r / sigma) ** 2)
    out = (-xhat[:n_par], cov_full[:n_par, :n_par], xhat[n_par:], chi2)
    if with_health:
        kept_min = torch.min(torch.where(ev_inv > 0.0, ev, evmax))
        out = out + (SolveDiag(
            n_truncated=torch.sum(ev_inv == 0.0).to(torch.int32),
            cond_log10=torch.log10(evmax / torch.clamp(kept_min,
                                                       min=1e-300))),)
    return out
