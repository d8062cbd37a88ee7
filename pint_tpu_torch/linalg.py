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

The PTA likelihood's stacked-array covariance goes through the
Kronecker-structured two-level Woodbury (the last section): per-pulsar
weighted grams over a :class:`RaggedStack` (kernel K3,
``csrc/kron_gram.cu``, on CUDA; :func:`kron_gram_plain` on the CPU), a
batched per-pulsar Cholesky, and one LU of the (P m2, P m2) GW sector.
Its dense counterpart, the reference's oracle for it, forms each grid
point's (K, K) capacity matrix from one gram: kernel K11
(``csrc/crn_capacity.cu``) writes gram + phi^-1 with the prior inverted
as m2 blocks of P x P, :func:`crn_capacity_plain` inverts the dense
prior as the reference does; kernel K11b (the same source) is its
backward, for the dense posterior's gradient.

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
#: relative ridge on each diagonal entry of a dense prior before its
#: Cholesky (pint_tpu linalg._phi_terms): a rank-deficient ORF (monopole,
#: dipole) leaves kron(orf, diag(phi_gw)) an exact null space
_PHI_JITTER = 1e-12

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
    plain PyTorch version of kernel K2 (CPU ``index_add`` adds rows in
    index order).  Out of place: it leaves its inputs alone."""
    k_e = offsets.numel() - 1
    counts = (offsets[1:] - offsets[:-1]).to(torch.int64)
    seg_of = torch.repeat_interleave(
        torch.arange(k_e, device=x.device), counts)
    out = torch.zeros((k_e, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add(0, seg_of, x[perm.to(torch.int64)])


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


@torch.library.custom_op("pint_tpu_torch::segment_sum", mutates_args=(),
                         device_types="cpu")
def _segment_sum_op(x: torch.Tensor, perm: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    return segment_sum_plain(x, perm, offsets)


@_segment_sum_op.register_kernel("cuda")
def _(x, perm, offsets):
    return segment_sum_cuda(x, perm, offsets)


@_segment_sum_op.register_fake
def _(x, perm, offsets):
    return x.new_empty((offsets.shape[0] - 1, x.shape[1]))


def _unbatched(name, in_dims, which):
    """Raise unless the arguments at positions ``which`` are unbatched:
    the batching rules batch the data, never the structure."""
    if any(in_dims[i] is not None for i in which):
        raise NotImplementedError(
            f"{name}: no batching rule for a batched structure argument")


@_segment_sum_op.register_vmap
def _(info, in_dims, x, perm, offsets):
    """The points fold into the columns: (B, N, M) becomes (N, B M), one
    K2 launch whatever B (each column's sum is the same either way)."""
    _unbatched("segment_sum", in_dims, (1, 2))
    x = x.movedim(in_dims[0], 1)
    n, b, m = x.shape
    out = _segment_sum_op(x.reshape(n, b * m), perm, offsets)
    return out.reshape(out.shape[0], b, m), 1


class _SegmentSum(torch.autograd.Function):
    """The segment sums with their forward-mode tangent: they are linear
    in x, so the tangent is the segment sums of x's tangent (K2 again on
    CUDA).  Without it ``torch.func.jacfwd`` would drop the tangent at
    the custom op and return zeros."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, perm, offsets):
        return _segment_sum_op(x, perm, offsets)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(inputs[1], inputs[2])

    @staticmethod
    def jvp(ctx, dx, _dperm, _doffsets):
        perm, offsets = ctx.saved_tensors
        return _segment_sum_op(dx, perm, offsets)

    @staticmethod
    def backward(ctx, _grad):
        raise NotImplementedError(
            "segment_sum (kernel K2) has a forward-mode rule only; its "
            "reverse-mode rule is not ported (ROADMAP queue 1 item 11)")


def segment_sum_fixed_order(x, perm, offsets):
    """Segment sums of ``x`` ((N,) or (N, M)) in a fixed order: K2 for
    CUDA tensors, the plain version for CPU tensors.  Under
    ``torch.func.vmap`` a batched ``x`` is one call (one launch);
    ``torch.func.jacfwd`` differentiates it."""
    vec = x.dim() == 1
    x2 = x[:, None] if vec else x
    if x2.device.type not in ("cuda", "cpu"):
        raise ValueError(f"segment_sum_fixed_order: no version for "
                         f"{x2.device}")
    out = _SegmentSum.apply(x2, perm, offsets)
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


def su_dense_rows(su: StructuredU, rows):
    """The dense (len(rows), K) rows of a structured basis: the
    streaming append's delta rows of a basis it never needs in full
    (pint_tpu linalg.py:126)."""
    rows = torch.as_tensor(rows, dtype=torch.int64, device=su.seg.device)
    ar = torch.arange(su.k_e, device=su.seg.device)
    ecorr = (su.seg[rows].to(torch.int64)[:, None] == ar[None, :]).to(
        torch.float64)
    return torch.cat([su.pre[rows], ecorr, su.post[rows]], dim=1)


def su_pad_rows(su: StructuredU, n_rows: int) -> StructuredU:
    """``n_rows`` zero rows appended, outside every epoch (pint_tpu
    linalg.py:137): the CSR is unchanged."""
    z = dict(dtype=torch.float64, device=su.pre.device)
    return StructuredU(
        pre=torch.cat([su.pre, torch.zeros((n_rows, su.pre.shape[1]), **z)]),
        seg=torch.cat([su.seg, torch.full((n_rows,), su.k_e,
                                          dtype=su.seg.dtype,
                                          device=su.seg.device)]),
        perm=su.perm, offsets=su.offsets,
        post=torch.cat([su.post, torch.zeros((n_rows, su.post.shape[1]),
                                             **z)]))


def basis_rows(U, rows):
    """Dense rows of a dense or structured basis."""
    if isinstance(U, StructuredU):
        return su_dense_rows(U, rows)
    return U[torch.as_tensor(rows, dtype=torch.int64, device=U.device)]


def basis_set_rows(U, row0, u_rows):
    """A copy of the basis ``U`` with rows ``[row0, row0 + len(u_rows))``
    replaced by the dense ``u_rows``.  For a structured basis the epoch
    block of ``u_rows`` must be an indicator (at most one 1 a row); the
    epoch CSR is rebuilt on the host."""
    dn = u_rows.shape[0]
    if not isinstance(U, StructuredU):
        out = U.clone()
        out[row0:row0 + dn] = u_rows
        return out
    k_pre, k_e = U.pre.shape[1], U.k_e
    e = u_rows[:, k_pre:k_pre + k_e]
    if not bool(torch.all((e == 0) | (e == 1))) \
            or bool(torch.any(e.sum(dim=1) > 1)):
        raise ValueError("basis_set_rows: the epoch block of the new rows "
                         "is not an indicator")
    pre, post, seg = U.pre.clone(), U.post.clone(), U.seg.clone()
    pre[row0:row0 + dn] = u_rows[:, :k_pre]
    post[row0:row0 + dn] = u_rows[:, k_pre + k_e:]
    seg[row0:row0 + dn] = torch.where(e.sum(dim=1) > 0, e.argmax(dim=1),
                                      k_e).to(seg.dtype)
    perm, offsets = epoch_csr(seg.cpu().numpy(), k_e)
    return StructuredU(pre=pre, seg=seg,
                       perm=torch.as_tensor(perm, device=seg.device),
                       offsets=torch.as_tensor(offsets, device=seg.device),
                       post=post)


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
    """Lower Cholesky factor of ``a`` (..., K, K); a matrix whose
    factorization fails comes back NaN-filled
    (``jax.scipy.linalg.cho_factor`` semantics), with no host sync."""
    L, info = torch.linalg.cholesky_ex(a)
    ok = (info == 0)[..., None, None]
    return torch.where(ok, L, torch.full_like(L, float("nan")))


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
    diagonal floored at ``_PHI_FLOOR``, or for a dense (K, K) prior
    covariance: each diagonal entry raised by ``_PHI_JITTER`` (|phi_ii| +
    ``_PHI_FLOOR``), then the Cholesky inverse and 2 sum log diag L
    (pint_tpu linalg.py:223; a failed factorization gives NaN).  The
    reference's ``jitter=`` escalation is not ported (ROADMAP queue 1
    item 3)."""
    if phi.dim() == 2:
        d = torch.abs(torch.diagonal(phi)) + _PHI_FLOOR
        L = cho_factor(phi + _PHI_JITTER * torch.diag(d))
        eye = torch.eye(phi.shape[0], dtype=phi.dtype, device=phi.device)
        return (torch.cholesky_solve(eye, L),
                2.0 * torch.sum(torch.log(torch.diagonal(L))))
    phi = torch.clamp(phi, min=_PHI_FLOOR)
    return torch.diag(1.0 / phi), torch.sum(torch.log(phi))


def _capacity(sigma, U, phi):
    """(nvec, L, logdet_phi): the Cholesky of the capacity matrix
    U^T N^-1 U + Phi^-1 every Woodbury path shares."""
    phi_inv, logdet_phi = _phi_terms(phi)
    nvec = sigma**2
    sigma_cap = _weighted_gram(U, 1.0 / nvec) + phi_inv
    return nvec, cho_factor(sigma_cap), logdet_phi


def woodbury_chi2_logdet(r, sigma, U, phi, valid=None):
    """(chi2, logdet C) for C = diag(sigma^2) + U Phi U^T, by the
    Woodbury identity and the matrix determinant lemma; ``phi`` is a (K,)
    weight vector (Phi diagonal) or a (K, K) prior covariance.  ``valid``
    masks bucketing pad rows out of the white logdet term (pint_tpu
    linalg.py:288)."""
    nvec, L, logdet_phi = _capacity(sigma, U, phi)
    ninv_r = r / nvec
    ut_ninv_r = _ut_dot(U, ninv_r)
    x = cho_solve(L, ut_ninv_r)
    chi2 = torch.sum(r * ninv_r) - torch.sum(ut_ninv_r * x)
    log_nvec = torch.log(nvec)
    if valid is not None:
        log_nvec = torch.where(valid, log_nvec, torch.zeros_like(log_nvec))
    logdet = (torch.sum(log_nvec) + logdet_phi
              + 2.0 * torch.sum(torch.log(torch.diagonal(L))))
    return chi2, logdet


def woodbury_solve(sigma, U, phi, y):
    """C^-1 y for C = diag(sigma^2) + U diag(phi) U^T, y (N,) or (N, M)
    (pint_tpu linalg.py:324, vector phi): the plain whitening the
    optimal statistic's gram route is held to."""
    nvec, L, _ = _capacity(sigma, U, phi)
    y2 = y if y.dim() == 2 else y[:, None]
    ninv_y = y2 / nvec[:, None]
    x = cho_solve(L, _ut_dot(U, ninv_y))
    out = ninv_y - _u_dot(U, x) / nvec[:, None]
    return out if y.dim() == 2 else out[:, 0]


def noise_gram_precompute(sigma, U, phi):
    """The constant (K, K) block of the GLS normal matrix,
    ``U^T diag(sigma^-2) U + Phi^-1`` (built once per fit when no free
    parameter touches the noise model)."""
    phi_inv, _ = _phi_terms(phi)
    return _weighted_gram(U, 1.0 / sigma**2) + phi_inv


# --------------------------------------------------------------------------
# Woodbury chi^2 against a prebuilt capacity factor (kernel K8)
# --------------------------------------------------------------------------

#: kernel K8 (replaces the r-dependent work of pint_tpu linalg.py:381
#: woodbury_chi2_logdet_pre), batched over residual vectors
K8 = CudaKernel(
    "woodbury_chi2_pre", "woodbury_pre.cu", "woodbury_chi2_pre_launch",
    [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 6)


class WoodburyPre(NamedTuple):
    """The pieces of the Woodbury chi^2 that do not depend on the
    residuals, built once for constant (sigma, U, phi) — a chi^2 grid
    whose noise parameters are all frozen (pint_tpu linalg.WoodburyPre).
    ``U`` stays a :class:`StructuredU` (the reference densifies it): its
    ECORR epoch block is ~6/7 of the columns of the B1855-like basis and
    enters every product as segment sums.  ``chol_upper`` is L^T, the
    layout kernel K8 reads L's columns in."""

    nvec: torch.Tensor        # (N,) sigma^2
    U: object                 # StructuredU or dense (N, K)
    chol_lower: torch.Tensor  # (K, K) lower Cholesky factor L of the capacity
    logdet: torch.Tensor      # logdet C
    chol_upper: torch.Tensor  # (K, K) L^T, contiguous


def woodbury_precompute(sigma, U, phi):
    """The capacity matrix's Cholesky factor and logdet C for constant
    (sigma, U, phi), phi a (K,) weight vector; call it once, outside any
    transform."""
    nvec, L, logdet_phi = _capacity(sigma, U, phi)
    logdet = (torch.sum(torch.log(nvec)) + logdet_phi
              + 2.0 * torch.sum(torch.log(torch.diagonal(L))))
    return WoodburyPre(nvec, U, L, logdet, L.T.contiguous())


def _basis_parts(U, n, device):
    """(dense pre, perm, offsets, dense post) of a dense or structured
    basis: a dense basis is all ``pre``, with no epoch."""
    if isinstance(U, StructuredU):
        return U.pre, U.perm, U.offsets, U.post
    i32 = dict(dtype=torch.int32, device=device)
    return (U, torch.zeros(0, **i32), torch.zeros(1, **i32),
            torch.zeros((n, 0), dtype=torch.float64, device=device))


def woodbury_chi2_pre_plain(r, nvec, pre, perm, offsets, post, lt):
    """chi^2 of r (N,) or (G, N) against C = N + U Phi U^T from the
    upper factor ``lt`` = L^T of the capacity matrix: the plain PyTorch
    version of kernel K8, the reference's lines (pint_tpu
    linalg.py:381-388) with U = [pre | epochs | post]:

        chi2 = sum r^2 / n - (U^T N^-1 r) . cho_solve(L, U^T N^-1 r)."""
    ninv_r = r / nvec
    y = ninv_r.T if r.dim() == 2 else ninv_r
    y2 = y if y.dim() == 2 else y[:, None]
    ut = torch.cat([pre.T @ y, segment_sum_plain(y2, perm, offsets)
                    .reshape((-1,) + tuple(y.shape[1:])), post.T @ y])
    x = cho_solve(lt.T, ut)
    return torch.sum(r * ninv_r, dim=-1) - torch.sum(ut * x, dim=0)


def k8_plan(g, n, k_pre, k_e, k_post):
    """K8's launch plan for G residual vectors of N rows against a basis
    of k_pre + k_e + k_post columns, as its library decides it
    (csrc/woodbury_pre.cu ``woodbury_chi2_pre_plan``): the ``rows`` of a
    row split, the number of ``splits``, the first stage's ``blocks``
    and the ``scratch`` the launcher takes, in doubles."""
    out = (ctypes.c_int64 * 4)()
    # the out pointer goes as an int64, the width of a pointer
    err = K8.call("woodbury_chi2_pre_plan", g, n, k_pre, k_e, k_post,
                  ctypes.addressof(out))
    if err:
        raise ValueError(f"k8_plan: no plan for G = {g}, N = {n}, "
                         f"K = {k_pre} + {k_e} + {k_post}")
    return dict(zip(("rows", "splits", "blocks", "scratch"), out))


def woodbury_chi2_pre_cuda(r, nvec, pre, perm, offsets, post, lt):
    """Kernel K8 on CUDA tensors: chi^2 of r (N,) or (G, N) in one
    launcher call (three kernels: the right-hand sides of all points,
    their fixed-order reduce, the blocked substitution; see
    :func:`k8_plan`); raises on what it does not take."""
    f64 = tuple(t.contiguous() for t in (r, nvec, pre, post, lt))
    i32 = tuple(t.contiguous() for t in (perm, offsets))
    dev = _check_cuda("woodbury_chi2_pre_cuda", f64)
    if any(t.device != dev or t.dtype != torch.int32 or t.dim() != 1
           for t in i32):
        raise ValueError("woodbury_chi2_pre_cuda: perm and offsets must "
                         "be 1-D int32 on the device")
    r, nvec, pre, post, lt = f64
    perm, offsets = i32
    batched = r.dim() == 2
    g = r.shape[0] if batched else 1
    n = nvec.shape[0]
    k_pre, k_post, k_e = pre.shape[1], post.shape[1], offsets.numel() - 1
    k = k_pre + k_e + k_post
    if r.shape[-1] != n or r.dim() not in (1, 2) or pre.shape[0] != n \
            or post.shape[0] != n or lt.shape != (k, k) \
            or perm.numel() > n or n == 0 or g == 0:
        raise ValueError("woodbury_chi2_pre_cuda: r (N,) or (G, N), nvec "
                         "(N,), pre (N, K_pre), post (N, K_post), lt (K, K)")
    plan = k8_plan(g, n, k_pre, k_e, k_post)
    scratch = torch.empty(plan["scratch"], dtype=torch.float64, device=dev)
    chi2 = torch.empty((g,) if batched else (), dtype=torch.float64,
                       device=dev)
    K8.launch(dev, r.data_ptr(), nvec.data_ptr(), pre.data_ptr(),
              perm.data_ptr(), offsets.data_ptr(), post.data_ptr(),
              lt.data_ptr(), chi2.data_ptr(), scratch.data_ptr(),
              plan["scratch"], g, n, k_pre, k_e, k_post)
    return chi2


@torch.library.custom_op("pint_tpu_torch::woodbury_chi2_pre",
                         mutates_args=(), device_types="cpu")
def _woodbury_chi2_pre_op(r: torch.Tensor, nvec: torch.Tensor,
                          pre: torch.Tensor, perm: torch.Tensor,
                          offsets: torch.Tensor, post: torch.Tensor,
                          lt: torch.Tensor) -> torch.Tensor:
    return woodbury_chi2_pre_plain(r, nvec, pre, perm, offsets, post, lt)


@_woodbury_chi2_pre_op.register_kernel("cuda")
def _(r, nvec, pre, perm, offsets, post, lt):
    return woodbury_chi2_pre_cuda(r, nvec, pre, perm, offsets, post, lt)


@_woodbury_chi2_pre_op.register_fake
def _(r, nvec, pre, perm, offsets, post, lt):
    return r.new_empty(r.shape[:-1])


@_woodbury_chi2_pre_op.register_vmap
def _(info, in_dims, r, nvec, pre, perm, offsets, post, lt):
    """A batch of residual vectors is one K8 launch, one block each."""
    _unbatched("woodbury_chi2_pre", in_dims, range(1, 7))
    r = r.movedim(in_dims[0], 0)
    lead = r.shape[:-1]
    out = _woodbury_chi2_pre_op(r.reshape(-1, r.shape[-1]), nvec, pre, perm,
                                offsets, post, lt)
    return out.reshape(lead), 0


class _WoodburyChi2Pre(torch.autograd.Function):
    """K8 without a derivative rule: a gradient through it, in either
    mode, raises naming the kernel (the custom op alone would drop a
    forward-mode tangent and return zeros)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(r, nvec, pre, perm, offsets, post, lt):
        return _woodbury_chi2_pre_op(r, nvec, pre, perm, offsets, post, lt)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(
            "woodbury_chi2_pre (kernel K8) has no derivative rule; "
            "differentiate the per-walker form (ROADMAP queue 1 item 14)")

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "woodbury_chi2_pre (kernel K8) has no derivative rule; "
            "differentiate the per-walker form (ROADMAP queue 1 item 14)")


def woodbury_chi2_logdet_pre(r, pre: WoodburyPre):
    """(chi2, logdet C) of r (N,) or (G, N) against a
    :func:`woodbury_precompute` result: only the r-dependent work runs,
    by kernel K8 on CUDA and its plain version on the CPU; under
    ``torch.func.vmap`` a batch of points is one call (one launch)."""
    if r.device.type not in ("cuda", "cpu"):
        raise ValueError(f"woodbury_chi2_logdet_pre: no version for "
                         f"{r.device}")
    dense_pre, perm, offsets, post = _basis_parts(pre.U, pre.nvec.shape[0],
                                                  pre.nvec.device)
    chi2 = _WoodburyChi2Pre.apply(r, pre.nvec, dense_pre, perm, offsets,
                                  post, pre.chol_upper)
    return chi2, pre.logdet


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
            # zeros over the timing block: block_diag has no batching
            # rule, and under vmap it would run once per pulsar
            mtcm = mtcm + torch.nn.functional.pad(phi_inv,
                                                  (n_par, 0, n_par, 0))
        rhs = mtn @ r
    if nb:
        if gram is not None:
            # the precomputed gram IS the Woodbury capacity matrix
            ninv_r = r / nvec
            chi2 = _gram_chi2(gram, torch.sum(r * ninv_r),
                              _ut_dot(U, ninv_r))
        else:
            chi2, _ = woodbury_chi2_logdet(r, sigma, U, phi)
    else:
        chi2 = torch.sum((r / sigma) ** 2)
    return _normal_tail(mtcm, rhs, n_par, chi2, with_health)


def _normal_tail(mtcm, rhs, n_par, chi2, with_health):
    """The solve every normal-equation path shares (pint_tpu
    linalg.py:405 and :882): column normalization, eigh with the
    1e-16 * lambda_max pseudo-inverse cutoff (pint_tpu keeps it over
    Cholesky; the port keeps it so truncation matches the reference).
    Returns (dpar, cov, noise_coeffs, chi2[, SolveDiag])."""
    norm = torch.sqrt(torch.diagonal(mtcm))
    norm = torch.where(norm == 0, torch.ones_like(norm), norm)
    mtcm_n = mtcm / torch.outer(norm, norm)
    ev, Q = torch.linalg.eigh(mtcm_n)
    evmax = torch.max(ev)
    keep = ev > 1e-16 * evmax
    ev_inv = torch.where(keep, 1.0 / ev, torch.zeros_like(ev))
    xhat = (Q @ (ev_inv * (Q.T @ (rhs / norm)))) / norm
    cov_full = (Q * ev_inv[None, :]) @ Q.T / torch.outer(norm, norm)
    out = (-xhat[:n_par], cov_full[:n_par, :n_par], xhat[n_par:], chi2)
    if with_health:
        kept_min = torch.min(torch.where(ev_inv > 0.0, ev, evmax))
        out = out + (SolveDiag(
            n_truncated=torch.sum(ev_inv == 0.0).to(torch.int32),
            cond_log10=torch.log10(evmax / torch.clamp(kept_min,
                                                       min=1e-300))),)
    return out


def _gram_chi2(gram, rr, y):
    """chi^2 = rr - y^T gram^-1 y through the capacity Cholesky: the
    gram fast path of :func:`gls_normal_solve` and the blocks' chi^2 of
    :func:`normal_solve_from_blocks`."""
    x = cho_solve(cho_factor(gram), y)
    return rr - torch.sum(y * x)


# --------------------------------------------------------------------------
# Kronecker-structured stacked-array prior (the GWB cross-pulsar block)
# --------------------------------------------------------------------------

#: kernel K3 (replaces pint_tpu linalg.py:605 kron_gram_precompute):
#: two launches a call, the split partial grams and their fixed-order sum
K3 = CudaKernel(
    "kron_gram_ragged", "kron_gram.cu", "kron_gram_launch",
    [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 5)
#: K3 cuts pulsar a's n_a rows into clamp(ceil(n_a / K3_SPLIT_ROWS), 1,
#: K3_MAX_SPLITS) even splits, one block each (:func:`k3_row_splits`):
#: constants, so the sums' order depends on the shapes only
K3_SPLIT_ROWS = 192
K3_MAX_SPLITS = 11


class KronPhi(NamedTuple):
    """The stacked PTA prior ``blockdiag_a(diag(phi_noise[a])) (+)
    kron(orf, diag(phi_gw))`` as its three factors (pint_tpu
    linalg.KronPhi).  ``phi_noise`` (P, nb_max) is zero-padded; a zero
    weight pins its (absent) column through ``_PHI_FLOOR``.
    ``phi_gw`` may carry leading batch dimensions (grid points)."""

    orf: torch.Tensor
    phi_gw: torch.Tensor
    phi_noise: torch.Tensor


class KronGram(NamedTuple):
    """Per-pulsar weighted grams, padded to the widest pulsar (pint_tpu
    linalg.KronGram): everything of the likelihood that depends on
    (r, sigma, U, F) and not on the prior weights."""

    g_uu: torch.Tensor      # (P, nb, nb)  U^T W U
    g_uf: torch.Tensor      # (P, nb, m2)  U^T W F
    g_ff: torch.Tensor      # (P, m2, m2)  F^T W F
    b_u: torch.Tensor       # (P, nb)      U^T W r
    b_f: torch.Tensor       # (P, m2)      F^T W r
    rr: torch.Tensor        # (P,)         r^T W r
    ld_white: torch.Tensor  # (P,)         sum log sigma^2


@dataclass
class RaggedStack:
    """Every pulsar's rows ``T_a = [U_a | F_a | r_a]``, ragged in rows
    and in U's width (no padding).

    t: flat float64, pulsar a's row-major (n_a, nb_a + m2 + 1) block at
    ``t_off[a]``; sigma: (N_tot,), pulsar a's at ``row_off[a] ..
    row_off[a+1]``; nb: (P,) int32 widths of U."""

    t: torch.Tensor
    sigma: torch.Tensor
    row_off: torch.Tensor
    t_off: torch.Tensor
    nb: torch.Tensor
    nb_host: tuple
    m2: int

    @property
    def n_psr(self) -> int:
        return len(self.nb_host)

    @property
    def nb_max(self) -> int:
        return max(self.nb_host)

    @property
    def n_rows(self) -> tuple:
        return tuple(int(x) for x in np.diff(self.row_off.cpu().numpy()))


def ragged_stack(rs, sigmas, Us, Fs, device) -> RaggedStack:
    """A :class:`RaggedStack` from per-pulsar host arrays r (n_a,),
    sigma (n_a,), U (n_a, nb_a), F (n_a, m2)."""
    m2 = int(np.shape(Fs[0])[1])
    blocks, nbs, rows = [], [], [0]
    for r, U, F in zip(rs, Us, Fs):
        r, U, F = (np.asarray(x, np.float64) for x in (r, U, F))
        blocks.append(np.concatenate([U, F, r[:, None]], axis=1).ravel())
        nbs.append(U.shape[1])
        rows.append(rows[-1] + len(r))
    sizes = [0] + [b.size for b in blocks]
    return RaggedStack(
        t=torch.as_tensor(np.concatenate(blocks), device=device),
        sigma=torch.as_tensor(np.concatenate(
            [np.asarray(s, np.float64) for s in sigmas]), device=device),
        row_off=torch.as_tensor(np.asarray(rows, np.int64), device=device),
        t_off=torch.as_tensor(np.cumsum(sizes).astype(np.int64),
                              device=device),
        nb=torch.as_tensor(np.asarray(nbs, np.int32), device=device),
        nb_host=tuple(nbs), m2=m2)


def _gram_split(gram, ld_white, nb_max) -> KronGram:
    """KronGram views of the padded (P, Wp, Wp) gram of [U | F | r]."""
    u, f = slice(0, nb_max), slice(nb_max, gram.shape[-1] - 1)
    return KronGram(*(t.contiguous() for t in (
        gram[:, u, u], gram[:, u, f], gram[:, f, f], gram[:, u, -1],
        gram[:, f, -1], gram[:, -1, -1], ld_white)))


def kron_gram_plain(st: RaggedStack):
    """(gram (P, Wp, Wp), ld_white (P,)): the plain PyTorch version of
    K3, one pulsar at a time."""
    nb_max, m2 = st.nb_max, st.m2
    wp = nb_max + m2 + 1
    dev = st.t.device
    gram = torch.zeros((st.n_psr, wp, wp), dtype=torch.float64, device=dev)
    ld = torch.empty(st.n_psr, dtype=torch.float64, device=dev)
    row_off = st.row_off.cpu().tolist()
    t_off = st.t_off.cpu().tolist()
    for a, nb in enumerate(st.nb_host):
        n = row_off[a + 1] - row_off[a]
        w = nb + m2 + 1
        t = st.t[t_off[a]:t_off[a] + n * w].view(n, w)
        s = st.sigma[row_off[a]:row_off[a + 1]]
        g = (t * (1.0 / s**2)[:, None]).T @ t
        cols = torch.cat([torch.arange(nb, device=dev),
                          torch.arange(nb_max, wp, device=dev)])
        gram[a, cols[:, None], cols[None, :]] = g
        ld[a] = torch.sum(torch.log(s**2))
    return gram, ld


def k3_row_splits(n: int):
    """[(first row, end row)] of K3's blocks over a pulsar of ``n``
    rows: ascending, covering every row once (the rule the kernel
    applies on the device)."""
    s = min(K3_MAX_SPLITS, max(1, -(-n // K3_SPLIT_ROWS)))
    return [(i * n // s, (i + 1) * n // s) for i in range(s)]


def _k3_blocks(wp: int) -> int:
    """16 x 8 blocks of K3's upper triangle at gram width ``wp``."""
    ni = -(-wp // 16)
    return ni * (ni + 1)


def kron_gram_cuda(st: RaggedStack):
    """Kernel K3 on CUDA tensors; raises on what it does not take."""
    dev = st.t.device
    parts = (st.t, st.sigma, st.row_off, st.t_off, st.nb)
    if dev.type != "cuda" or any(x.device != dev for x in parts):
        raise ValueError("kron_gram_cuda: every RaggedStack tensor must be "
                         "on one CUDA device")
    if st.t.dtype != torch.float64 or st.sigma.dtype != torch.float64 \
            or st.row_off.dtype != torch.int64 \
            or st.t_off.dtype != torch.int64 or st.nb.dtype != torch.int32:
        raise ValueError("kron_gram_cuda: t, sigma float64; row_off, t_off "
                         "int64; nb int32")
    if not all(x.is_contiguous() for x in parts):
        raise ValueError("kron_gram_cuda: inputs must be contiguous")
    wp = st.nb_max + st.m2 + 1
    f64 = dict(dtype=torch.float64, device=dev)
    # the kernel writes every pulsar column; narrower pulsars leave pad
    gram = (torch.empty if min(st.nb_host) == st.nb_max
            else torch.zeros)((st.n_psr, wp, wp), **f64)
    ld = torch.empty(st.n_psr, **f64)
    part = torch.empty((st.n_psr, K3_MAX_SPLITS, _k3_blocks(wp), 128),
                       **f64)
    ld_part = torch.empty((st.n_psr, K3_MAX_SPLITS), **f64)
    K3.launch(dev, *(x.data_ptr() for x in parts), part.data_ptr(),
              ld_part.data_ptr(), gram.data_ptr(), ld.data_ptr(), st.n_psr,
              st.nb_max, st.m2, K3_SPLIT_ROWS, K3_MAX_SPLITS)
    return gram, ld


def kron_gram_precompute(st: RaggedStack) -> KronGram:
    """The per-pulsar weighted grams: K3 for CUDA tensors, the plain
    version for CPU tensors."""
    if st.t.device.type == "cuda":
        gram, ld = kron_gram_cuda(st)
    elif st.t.device.type == "cpu":
        gram, ld = kron_gram_plain(st)
    else:
        raise ValueError(f"kron_gram_precompute: no version for "
                         f"{st.t.device}")
    return _gram_split(gram, ld, st.nb_max)


def kron_gw_blocks(kp: KronPhi):
    """(..., m2, P, P) per-frequency GW prior blocks ``phi_gw[i] * orf``
    with the 1e-12 relative diagonal ridge (pint_tpu linalg.py:627)."""
    orf, phi_gw = kp.orf, kp.phi_gw
    blocks = phi_gw[..., :, None, None] * orf
    d = torch.abs(phi_gw[..., :, None] * torch.diagonal(orf)) + _PHI_FLOOR
    return blocks + torch.diag_embed(_PHI_JITTER * d)


def kron_phi_dense(kp: KronPhi):
    """The dense (K, K) prior a :class:`KronPhi` stands for, columns
    ``[pulsar-major noise | pulsar-major GW]`` (verification form)."""
    phi_n = torch.diag(kp.phi_noise.reshape(-1))
    gw = torch.kron(kp.orf, torch.diag(kp.phi_gw))
    return torch.block_diag(phi_n, gw)


# --------------------------------------------------------------------------
# the per-pulsar capacity stage (kernels K5 / K5b and their plain versions)
# --------------------------------------------------------------------------

#: kernel K5 (replaces pint_tpu linalg.py:667's per-pulsar ``one``,
#: :701-713)
K5 = CudaKernel(
    "kron_pulsar_fwd", "kron_pulsar.cu", "kron_pulsar_fwd_launch",
    [ctypes.c_void_p] * 14 + [ctypes.c_int64] * 4)
#: kernel K5b (replaces the jax.grad of the same through phi)
K5B = CudaKernel(
    "kron_pulsar_bwd", "kron_pulsar.cu", "kron_pulsar_bwd_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 3)

#: the wide forms of K5 and K5b (the capacity in global memory, staged
#: through shared memory by tiles, products on the fp64 MMA), for
#: pulsars too wide for the two above; each takes a scratch of
#: ``kron_pulsar_wide_scratch`` doubles a block after its outputs
K5W = CudaKernel(
    "kron_pulsar_fwd_wide", "kron_pulsar.cu", "kron_pulsar_fwd_wide_launch",
    [ctypes.c_void_p] * 15 + [ctypes.c_int64] * 4)
K5BW = CudaKernel(
    "kron_pulsar_bwd_wide", "kron_pulsar.cu", "kron_pulsar_bwd_wide_launch",
    [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 3)

#: one block's shared memory on an H100 (227 kB): the widest (nb, m2) the
#: narrow K5 and K5b take
K5_SHARED_BYTES = 232448


def kron_pulsar_plain(pre: KronGram, phi):
    """(chi2, x, m, ld, L, X) over phi (B, P, nb): the plain PyTorch
    version of K5, one batched ``cholesky_ex`` of the (B, P, nb, nb)
    capacity matrices.  L is the lower Cholesky factor, X = cap^-1
    [b_u | g_uf] (B, P, nb, 1 + m2)."""
    phi_n = torch.clamp(phi, min=_PHI_FLOOR)
    L = cho_factor(pre.g_uu + torch.diag_embed(1.0 / phi_n))
    rhs = torch.cat([pre.b_u[..., None], pre.g_uf], dim=-1)
    X = torch.cholesky_solve(rhs.expand(L.shape[:-1] + rhs.shape[-1:]), L)
    x_u, x_uf = X[..., 0], X[..., 1:]
    g_fu = pre.g_uf.transpose(-1, -2)
    chi2 = pre.rr - torch.sum(pre.b_u * x_u, dim=-1)
    z = pre.b_f - (g_fu @ x_u[..., None])[..., 0]
    m = pre.g_ff - g_fu @ x_uf
    ld = (pre.ld_white + torch.sum(torch.log(phi_n), dim=-1)
          + 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                            dim=-1))
    return chi2, z, m, ld, L, X


def kron_pulsar_bwd_plain(phi, L, X, gchi, gx, gm, gld):
    """d(outputs)/d phi contracted with the output gradients: the plain
    PyTorch version of K5b (module docstring of ``csrc/kron_pulsar.cu``
    for the formula)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    w = torch.linalg.solve_triangular(L, eye.expand(L.shape), upper=False)
    d_inv = torch.sum(w * w, dim=-2)                 # diag(cap^-1)
    x_u, x_uf = X[..., 0], X[..., 1:]
    q = torch.sum(x_uf * gx[..., None, :], dim=-1)
    s = torch.sum(x_uf * (x_uf @ gm.transpose(-1, -2)), dim=-1)
    br = gchi[..., None] * (x_u * x_u) + x_u * q + s + gld[..., None] * d_inv
    ok = phi >= _PHI_FLOOR
    phi_c = torch.where(ok, phi, torch.ones_like(phi))
    g = gld[..., None] / phi_c - br / (phi_c * phi_c)
    return torch.where(ok, g, torch.zeros_like(g))


def _check_cuda(name, tensors):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs must be on one CUDA device")
    if any(t.dtype != torch.float64 for t in tensors):
        raise ValueError(f"{name}: inputs must be float64")
    return dev


def k5_shared_bytes(nb, m2):
    """Shared memory of one K5 block (the capacity padded to a multiple
    of 8 and its right-hand sides to one of 16, row strides + 4, and
    below 3 block rows the diagonal blocks' inverses) and the least of
    one K5b block (L's lower 8 x 8 tiles of 96 doubles and two
    nb-vectors; the library stages X, gM and gx beside them where they
    fit, ``K5B.call("kron_pulsar_bwd_smem", nb, m2)``;
    csrc/kron_pulsar.cu)."""
    nbp, rp = -(-nb // 8) * 8, -(-(1 + m2) // 16) * 16
    nt = nbp // 8
    return (8 * (nbp * (nbp + 4) + nbp * (rp + 4) + (nt * 96 if nt < 3
                                                     else 0)),
            8 * (nt * (nt + 1) // 2 * 96 + 2 * nbp))


def _k5_shape(nb, m2):
    """(forward form, backward form) at (nb, m2): the narrow form where
    its block's shared memory holds the capacity, else the wide form."""
    return tuple("narrow" if b <= K5_SHARED_BYTES else "wide"
                 for b in k5_shared_bytes(nb, m2))


def k5_wide_panel(nb):
    """The wide forms' panel width at nb, from the kernels' library (it
    builds the library): 32, 16 or 8, the widest at which both kernels'
    shared memory fits (K5w: the panel below the diagonal block, roundup
    (nb, panel) + 16 rows; K5bw: a panel of L^-1, roundup16(nb) rows,
    beside a strip of L at least 16 columns deep); 0 where nb is too
    wide for them."""
    return K5W.call("kron_pulsar_wide_panel", nb)


def _wide_scratch(nb, m2, n_blocks, dev):
    """The wide forms' scratch (their diagonal tiles' inverses) for
    ``n_blocks`` blocks; raises where nb is too wide for them."""
    per_block = K5W.call("kron_pulsar_wide_scratch", nb)
    if not per_block:
        raise ValueError(f"K5/K5b: nb = {nb}, m2 = {m2} does not fit one "
                         "block's shared memory in either form")
    return torch.empty(n_blocks * per_block, dtype=torch.float64,
                       device=dev)


def kron_pulsar_cuda(pre: KronGram, phi):
    """Kernel K5 on CUDA tensors, phi (B, P, nb); the same outputs as
    :func:`kron_pulsar_plain`.  The narrow form where one block's shared
    memory holds the capacity, the wide form K5w beyond; raises on what
    neither takes."""
    grams = tuple(t.contiguous() for t in pre)
    dev = _check_cuda("kron_pulsar_cuda", (phi,) + grams)
    b, p, nb = phi.shape
    m2 = pre.g_ff.shape[-1]
    if pre.g_uu.shape != (p, nb, nb) or pre.g_uf.shape != (p, nb, m2):
        raise ValueError("kron_pulsar_cuda: phi (B, P, nb) against grams "
                         "g_uu (P, nb, nb), g_uf (P, nb, m2)")
    form, _ = _k5_shape(nb, m2)
    if form == "wide":
        scratch = _wide_scratch(nb, m2, b * p, dev)
    phi = phi.contiguous()
    f64 = dict(dtype=torch.float64, device=dev)
    chi2 = torch.empty((b, p), **f64)
    x = torch.empty((b, p, m2), **f64)
    m = torch.empty((b, p, m2, m2), **f64)
    ld = torch.empty((b, p), **f64)
    L = torch.empty((b, p, nb, nb), **f64)
    X = torch.empty((b, p, nb, 1 + m2), **f64)
    ptrs = (phi.data_ptr(), *(t.data_ptr() for t in grams),
            chi2.data_ptr(), x.data_ptr(), m.data_ptr(), ld.data_ptr(),
            L.data_ptr(), X.data_ptr())
    if b * p and form == "narrow":
        K5.launch(dev, *ptrs, b * p, p, nb, m2)
    elif b * p:  # L and X are the wide form's working storage
        K5W.launch(dev, *ptrs, scratch.data_ptr(), b * p, p, nb, m2)
    return chi2, x, m, ld, L, X


def kron_pulsar_bwd_cuda(phi, L, X, gchi, gx, gm, gld):
    """Kernel K5b on CUDA tensors (the shapes of
    :func:`kron_pulsar_cuda`'s inputs and outputs): the narrow form, or
    the wide form K5bw where the narrow one's shared memory does not
    hold L^-1."""
    ts = tuple(t.contiguous() for t in (phi, L, X, gchi, gx, gm, gld))
    dev = _check_cuda("kron_pulsar_bwd_cuda", ts)
    b, p, nb = phi.shape
    m2 = gx.shape[-1]
    if L.shape != (b, p, nb, nb) or X.shape != (b, p, nb, 1 + m2) \
            or gm.shape != (b, p, m2, m2) or gchi.shape != (b, p) \
            or gld.shape != (b, p):
        raise ValueError("kron_pulsar_bwd_cuda: shapes do not match phi "
                         "(B, P, nb)")
    _, form = _k5_shape(nb, m2)
    if form == "wide":
        scratch = _wide_scratch(nb, m2, b * p, dev)
    gphi = torch.empty_like(ts[0])
    ptrs = (*(t.data_ptr() for t in ts), gphi.data_ptr())
    if b * p and form == "narrow":
        K5B.launch(dev, *ptrs, b * p, nb, m2)
    elif b * p:
        K5BW.launch(dev, *ptrs, scratch.data_ptr(), b * p, nb, m2)
    return gphi


class _KronPulsarTerms(torch.autograd.Function):
    """The per-pulsar stage as one differentiable operation: K5 forward
    and K5b backward on CUDA tensors, their plain versions on CPU
    tensors.  Only phi (B, P, nb) is differentiated."""

    @staticmethod
    def forward(ctx, phi, *grams):
        pre = KronGram(*grams)
        if phi.device.type == "cuda":
            chi2, x, m, ld, L, X = kron_pulsar_cuda(pre, phi)
        elif phi.device.type == "cpu":
            chi2, x, m, ld, L, X = kron_pulsar_plain(pre, phi)
        else:
            raise ValueError(f"kron_pulsar_terms: no version for "
                             f"{phi.device}")
        ctx.save_for_backward(phi, L, X)
        return chi2, x, m, ld

    @staticmethod
    def backward(ctx, gchi, gx, gm, gld):
        phi, L, X = ctx.saved_tensors
        b, p, nb = phi.shape
        m2 = X.shape[-1] - 1

        def zero(g, shape):
            return g if g is not None else phi.new_zeros(shape)
        args = (phi, L, X, zero(gchi, (b, p)), zero(gx, (b, p, m2)),
                zero(gm, (b, p, m2, m2)), zero(gld, (b, p)))
        if phi.device.type == "cuda":
            gphi = kron_pulsar_bwd_cuda(*args)
        else:
            gphi = kron_pulsar_bwd_plain(*args)
        return (gphi,) + (None,) * len(KronGram._fields)


def kron_pulsar_terms(pre: KronGram, phi_noise):
    """Each pulsar's own-noise Woodbury reduction:

    chi2_a = r^T C_a^-1 r, x_a = F^T C_a^-1 r, m_a = F^T C_a^-1 F and
    ld_a = logdet C_a, with C_a = diag(sigma^2) + U diag(phi) U^T.

    ``phi_noise`` is (..., P, nb) with any leading chain dimensions; the
    grams (P, ...) are shared by every chain.  The outputs carry the
    same leading dimensions.  Differentiable in ``phi_noise`` only
    (kernel K5 forward, K5b backward on CUDA; their plain versions on
    the CPU); a gram that requires grad raises.  x_a and m_a are the
    optimal statistic's whitened z_a and M_a."""
    if any(t.requires_grad for t in pre):
        raise ValueError("kron_pulsar_terms differentiates phi_noise only; "
                         "a gram requires grad")
    lead = phi_noise.shape[:-2]
    p, nb = phi_noise.shape[-2:]
    m2 = pre.g_ff.shape[-1]
    if nb == 0:
        return tuple(t.expand(lead + t.shape) for t in
                     (pre.rr, pre.b_f, pre.g_ff, pre.ld_white))
    phi = phi_noise.reshape((-1, p, nb))
    chi2, x, m, ld = _KronPulsarTerms.apply(phi, *pre)
    return (chi2.reshape(lead + (p,)), x.reshape(lead + (p, m2)),
            m.reshape(lead + (p, m2, m2)), ld.reshape(lead + (p,)))


def kron_gw_terms(x, m, kp: KronPhi):
    """(corr, logdet_t) of the GW sector for every leading index:
    ``X^T Phi (I + M Phi)^-1 X`` and ``log|det(I + M Phi)|`` over the
    (P m2, P m2) system (pint_tpu linalg.py:707-735).  x (..., P, m2),
    m (..., P, m2, m2) and ``kp.phi_gw`` (..., m2) broadcast over their
    leading dimensions (chains, grid points).

    M is block-diagonal over pulsars and Phi block-diagonal over
    frequencies, so ``(M Phi)[(a,i),(b,j)] = m[a,i,j] B_j[a,b]`` is
    formed entrywise, never by a dense product; one LU serves the solve
    and the determinant.  Differentiable through autograd (the LU's
    gradient is PyTorch's)."""
    blocks = kron_gw_blocks(kp)                       # (..., m2, P, P)
    p, m2 = x.shape[-2:]
    pm = p * m2
    batch = torch.broadcast_shapes(x.shape[:-2], m.shape[:-3],
                                   blocks.shape[:-3])
    bt = blocks.movedim(-3, -1)                       # (..., a, b, j)
    t = (m.unsqueeze(-2) * bt.unsqueeze(-3)).reshape(batch + (pm, pm))
    t.diagonal(dim1=-2, dim2=-1).add_(1.0)
    lu, piv, _ = torch.linalg.lu_factor_ex(t)
    del t
    xf = x.expand(batch + (p, m2)).reshape(batch + (pm,))
    y = torch.linalg.lu_solve(lu, piv, xf[..., None])[..., 0]
    y = y.reshape(batch + (p, m2))
    phi_y = torch.einsum("...iab,...bi->...ai", blocks, y)
    corr = torch.sum(phi_y.reshape(batch + (pm,)) * xf, dim=-1)
    logdet = torch.sum(torch.log(torch.abs(
        torch.diagonal(lu, dim1=-2, dim2=-1))), dim=-1)
    return corr, logdet


def kron_chi2_logdet_pre(pre: KronGram, kp: KronPhi):
    """(chi2, logdet C) of the stacked array against precomputed grams
    (pint_tpu linalg.py:667): the two-level Woodbury, with the prior
    only ever multiplied, never inverted."""
    chi2_d, x, m, ld_d = kron_pulsar_terms(pre, kp.phi_noise)
    corr, ld_t = kron_gw_terms(x, m, kp)
    return (torch.sum(chi2_d, dim=-1) - corr,
            torch.sum(ld_d, dim=-1) + ld_t)


def kron_chi2_logdet(st: RaggedStack, kp: KronPhi):
    """(chi2, logdet C) for the stacked-array covariance

        C = blockdiag_a(diag(sigma_a^2) + U_a diag(phi_noise[a]) U_a^T)
            + blockdiag_a(F_a) kron(orf, diag(phi_gw)) blockdiag_a(F_a)^T

    over a ragged stack (pint_tpu linalg.py:738)."""
    return kron_chi2_logdet_pre(kron_gram_precompute(st), kp)


def kron_gram_append(pre: KronGram, pulsar, row0, r_rows, sigma_rows,
                     u_rows, f_rows) -> KronGram:
    """``pre`` extended by rows appended to pulsar ``pulsar`` (pint_tpu
    linalg.py:1001): r (n,), sigma (n,), U (n, nb_max) zero-padded as
    the grams are, F (n, m2).  The weighted row products are added onto
    that pulsar's blocks and sum log sigma^2 of the rows onto its white
    logdet; every other pulsar's blocks are untouched, out of place.  The
    update is purely additive, so ``row0`` (where the rows start in the
    pulsar's stack) is not read, as in the reference."""
    del row0
    w = 1.0 / sigma_rows**2
    uw = u_rows * w[:, None]
    fw = f_rows * w[:, None]

    def bump(t, delta):
        out = t.clone()
        out[pulsar] = out[pulsar] + delta
        return out

    return KronGram(
        g_uu=bump(pre.g_uu, uw.T @ u_rows),
        g_uf=bump(pre.g_uf, uw.T @ f_rows),
        g_ff=bump(pre.g_ff, fw.T @ f_rows),
        b_u=bump(pre.b_u, uw.T @ r_rows),
        b_f=bump(pre.b_f, fw.T @ r_rows),
        rr=bump(pre.rr, torch.sum(r_rows * w * r_rows)),
        ld_white=bump(pre.ld_white, torch.sum(torch.log(sigma_rows**2))))


# --------------------------------------------------------------------------
# the dense common-red-noise capacity (kernel K11 and its plain version)
# --------------------------------------------------------------------------

#: kernel K11 (replaces the dense prior, its inverse and the capacity add
#: of pint_tpu gw/common.py:186 _crn_lnlike_one, vmapped at :207); four
#: kernels a call: the ORF blocks' inverses and then the copy of the GW x
#: GW quadrant with them, beside the copy of the rest of S; the logdet
#: sums
K11 = CudaKernel(
    "crn_capacity", "crn_capacity.cu", "crn_capacity_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 6)
#: kernel K11b (replaces the jax.grad of the same through the dense
#: prior, pint_tpu gw/hmc.py:270 _dense_chi2_logdet and linalg.py:223
#: _phi_terms); one kernel a call: the noise weights' cotangents and the
#: GW blocks'
K11B = CudaKernel(
    "crn_capacity_bwd", "crn_capacity.cu", "crn_capacity_bwd_launch",
    [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 6)


def _noise_rows(phi_noise, g):
    """``phi_noise`` (kn,) shared by ``g`` points, or (G, kn) a row a
    point, as (G, kn) (a view)."""
    return phi_noise.expand(g, -1) if phi_noise.dim() == 1 else phi_noise


def crn_capacity_plain(gram, phi_noise, orf, phi_gw):
    """(S (G, K, K), logdet_phi (G,)): S_g = gram + phi_g^-1 for the
    dense prior phi_g = blockdiag(diag(phi_noise[g]), kron(orf,
    diag(phi_gw[g]))) in the reference's pulsar-major column order, its
    inverse by :func:`_phi_terms` (pint_tpu gw/common.py:194-200,
    linalg.py:223): the plain PyTorch version of K11, K^3 a point.
    ``phi_noise`` is (kn,), shared by every point, or (G, kn)."""
    out, lds = [], []
    for pn, pg in zip(_noise_rows(phi_noise, phi_gw.shape[0]), phi_gw):
        phi_inv, ld = _phi_terms(kron_phi_dense(
            KronPhi(orf=orf, phi_gw=pg, phi_noise=pn)))
        out.append(gram + phi_inv)
        lds.append(ld)
    return torch.stack(out), torch.stack(lds)


def crn_gw_inverse_plain(orf, phi_gw):
    """(G, m2, P, P): the inverse of every jittered GW block
    phi_gw[g, f] orf + 1e-12 diag(|phi_gw[g, f] orf_aa| + 1e-30), by its
    Cholesky (NaN where it fails), as K11 forms them in its scratch."""
    blocks = kron_gw_blocks(KronPhi(orf=orf, phi_gw=phi_gw,
                                    phi_noise=None))
    return torch.cholesky_inverse(cho_factor(blocks))


def crn_capacity_bwd_plain(gS, gld, phi_noise, phi_gw, M):
    """The plain PyTorch version of K11b: (g_phi_noise (G, kn),
    g_phi_gw (G, m2)) from the cotangents gS (G, K, K) of S and gld (G,)
    of logdet phi, with M (G, m2, P, P) the GW blocks' inverses.  With
    phi' = phi + 1e-12 (|phi| + 1e-30) on each noise column,

        g_phi_noise = (gld / phi' - gS_jj / phi'^2) (1 + 1e-12 sign phi).

    The GW block B_f = phi_f orf + 1e-12 diag(|phi_f orf_aa| + 1e-30)
    of :func:`_phi_terms`' dense branch is phi_f W + e I with W = dB_f /
    dphi_f = orf + 1e-12 diag(sign(phi_f orf_aa) orf_aa) and e = 1e-42.
    So with gM_f the block of gS on the GW columns kn + a m2 + f and gB_f
    = gld M_f - M_f sym(gM_f) M_f the cotangent of B_f,

        g_phi_gw[f] = <gB_f, W> = <gB_f, B_f - e I> / phi_f
                    = (gld P - <gM_f, sym(M_f)>) / phi_f - e tr(gB_f) / phi_f,

    a gather and a dot product a block.  The last term is left out: it
    is below e ||M_f|| of the rest, and ||M_f|| <= 1 / (1e-12 phi_f min
    orf_aa) even under a rank-deficient ORF (the ridge), so below 1e-30 /
    phi_f.  phi_gw must be nonzero (a power law's is positive)."""
    g, m2 = phi_gw.shape
    p = M.shape[-1]
    kn = gS.shape[-1] - p * m2
    pn = _noise_rows(phi_noise, g)
    pp = pn + _PHI_JITTER * (torch.abs(pn) + _PHI_FLOOR)
    d = torch.diagonal(gS, dim1=-2, dim2=-1)[:, :kn]
    j = torch.full_like(pn, _PHI_JITTER)
    dp = 1.0 + torch.where(pn >= 0.0, j, -j)
    g_noise = (gld[:, None] / pp - d / (pp * pp)) * dp
    # gM[g, f, a, b] = gS[g, kn + a m2 + f, kn + b m2 + f]
    gm = torch.diagonal(gS[:, kn:, kn:].reshape(g, p, m2, p, m2), dim1=2,
                        dim2=4).permute(0, 3, 1, 2)
    ms = 0.5 * (M + M.transpose(-1, -2))
    return g_noise, (gld[:, None] * p - torch.sum(gm * ms, dim=(-2, -1))) \
        / phi_gw


def _crn_shapes(name, gram, phi_noise, orf, phi_gw):
    """(G, K, kn, P, m2, noise stride) of K11's inputs; raises on what
    the kernels do not take."""
    g, m2 = phi_gw.shape
    p, k = orf.shape[0], gram.shape[0]
    kn = phi_noise.shape[-1]
    if orf.shape != (p, p) or gram.shape != (k, k) or k != kn + p * m2 \
            or phi_noise.shape not in ((kn,), (g, kn)):
        raise ValueError(f"{name}: gram (K, K) with K = kn + P m2 against "
                         "phi_noise (kn,) or (G, kn), orf (P, P), phi_gw "
                         "(G, m2)")
    return g, k, kn, p, m2, kn if phi_noise.dim() == 2 else 0


def crn_capacity_cuda(gram, phi_noise, orf, phi_gw):
    """Kernel K11 on CUDA tensors: (S, logdet_phi) of
    :func:`crn_capacity_plain` and the GW blocks' inverses M (G, m2, P,
    P), which K11b reads.  The GW sector as m2 independent P x P blocks a
    point, each factored and inverted in one block's shared memory
    (raises where P x P does not fit it), and the rest of G0 read once
    and written to every point."""
    ts = tuple(t.contiguous() for t in (gram, phi_noise, orf, phi_gw))
    dev = _check_cuda("crn_capacity_cuda", ts)
    g, k, kn, p, m2, ns = _crn_shapes("crn_capacity_cuda", *ts)
    if not K11.call("crn_capacity_smem", p):
        raise NotImplementedError(
            f"K11: a {p} x {p} ORF block does not fit one block's shared "
            "memory; the dense CRN path of wider arrays is not ported "
            "(ROADMAP queue 1 item 8)")
    f64 = dict(dtype=torch.float64, device=dev)
    S = torch.empty((g, k, k), **f64)
    ld = torch.empty(g, **f64)
    ld_blk = torch.empty((g, m2), **f64)
    blocks = torch.empty((g, m2, p, p), **f64)  # each ORF block's inverse
    if g:
        K11.launch(dev, *(t.data_ptr() for t in ts), S.data_ptr(),
                   ld.data_ptr(), ld_blk.data_ptr(), blocks.data_ptr(), g,
                   k, kn, ns, p, m2)
    return S, ld, blocks


def crn_capacity_bwd_cuda(gS, gld, phi_noise, phi_gw, M):
    """Kernel K11b on CUDA tensors, the outputs of
    :func:`crn_capacity_bwd_plain`."""
    ts = tuple(t.contiguous() for t in (gS, gld, phi_noise, phi_gw, M))
    dev = _check_cuda("crn_capacity_bwd_cuda", ts)
    gS, gld, phi_noise, phi_gw, M = ts
    g, m2 = phi_gw.shape
    p = M.shape[-1]
    k = gS.shape[-1]
    kn = phi_noise.shape[-1]
    if gS.shape != (g, k, k) or gld.shape != (g,) \
            or M.shape != (g, m2, p, p) or k != kn + p * m2 \
            or phi_noise.shape not in ((kn,), (g, kn)):
        raise ValueError("crn_capacity_bwd_cuda: gS (G, K, K), gld (G,), "
                         "phi_noise (kn,) or (G, kn), phi_gw (G, m2), M (G, "
                         "m2, P, P) with K = kn + P m2")
    g_noise = torch.empty((g, kn), dtype=torch.float64, device=dev)
    g_gw = torch.empty((g, m2), dtype=torch.float64, device=dev)
    if g:
        K11B.launch(dev, *(t.data_ptr() for t in ts), g_noise.data_ptr(),
                    g_gw.data_ptr(), g, k, kn,
                    kn if phi_noise.dim() == 2 else 0, p, m2)
    return g_noise, g_gw


class _CrnCapacity(torch.autograd.Function):
    """K11 forward and K11b backward on CUDA tensors, their plain
    versions on CPU tensors; differentiable in phi_noise and phi_gw."""

    @staticmethod
    def forward(ctx, gram, phi_noise, orf, phi_gw):
        if gram.device.type == "cuda":
            S, ld, M = crn_capacity_cuda(gram, phi_noise, orf, phi_gw)
        elif gram.device.type == "cpu":
            S, ld = crn_capacity_plain(gram, phi_noise, orf, phi_gw)
            M = None
        else:
            raise ValueError(f"crn_capacity: no version for {gram.device}")
        ctx.save_for_backward(phi_noise, orf, phi_gw, M)
        return S, ld

    @staticmethod
    def backward(ctx, gS, gld):
        phi_noise, orf, phi_gw, M = ctx.saved_tensors
        g = phi_gw.shape[0]
        if gS is None:
            k = orf.shape[0] * phi_gw.shape[1] + phi_noise.shape[-1]
            gS = phi_gw.new_zeros((g, k, k))
        if gld is None:
            gld = phi_gw.new_zeros(g)
        if phi_gw.device.type == "cuda":
            g_noise, g_gw = crn_capacity_bwd_cuda(gS, gld, phi_noise,
                                                  phi_gw, M)
        else:
            g_noise, g_gw = crn_capacity_bwd_plain(
                gS, gld, phi_noise, phi_gw,
                crn_gw_inverse_plain(orf, phi_gw))
        if phi_noise.dim() == 1:
            g_noise = torch.sum(g_noise, dim=0)
        return None, g_noise, None, g_gw


def crn_capacity(gram, phi_noise, orf, phi_gw):
    """(S (G, K, K), logdet_phi (G,)) of :func:`crn_capacity_plain`: K11
    for CUDA tensors, its plain version for CPU tensors.  Differentiable
    in ``phi_noise`` ((kn,) or (G, kn)) and ``phi_gw`` (G, m2): K11b on
    CUDA, its plain version on the CPU; a gram or ORF that requires grad
    raises."""
    if gram.requires_grad or orf.requires_grad:
        raise ValueError("crn_capacity differentiates phi_noise and phi_gw "
                         "only; the gram or the ORF requires grad")
    return _CrnCapacity.apply(gram, phi_noise, orf, phi_gw)


# --------------------------------------------------------------------------
# the WLS whitening pass (kernel K7 and its plain version)
# --------------------------------------------------------------------------

#: kernel K7 (replaces pint_tpu fitter.py:152-158 inside wls_gn_solve)
K7 = CudaKernel(
    "wls_whiten", "wls_whiten.cu", "wls_whiten_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 4)

#: the widest design K7 takes: its second launch holds the P + 1 column
#: values in shared memory beside a run of rows' weights
K7_MAX_COLS = 4096
#: the most points one K7 launch takes (its grid's second dimension)
K7_MAX_POINTS = 65535


def wls_whiten_plain(r, J, err):
    """(rw, Jn, norms, chi2) of the WLS step, the JAX package's lines in
    plain PyTorch: w = 1/err, rw = r w, Jn = (J w) / norms with the
    column norms' zeros replaced by 1, chi2 = sum rw^2.  r (..., N),
    J (..., N, P), err (N,) or (..., N): leading dimensions are points."""
    w = 1.0 / err
    rw = r * w
    Jw = J * w[..., None]
    norms = torch.sqrt(torch.sum(Jw * Jw, dim=-2))
    norms = torch.where(norms == 0, torch.ones_like(norms), norms)
    return rw, Jw / norms[..., None, :], norms, torch.sum(rw * rw, dim=-1)


def wls_whiten_cuda(r, J, err):
    """Kernel K7 on CUDA tensors: r (N,) and J (N, P), or G points
    stacked, r (G, N) and J (G, N, P); err (N,) shared by the points or
    (G, N).  The outputs of :func:`wls_whiten_plain`, the column sums in
    a fixed order, one launcher call for all points (one cooperative
    launch where every row tile fits the card's shared memory at once,
    else two)."""
    ts = tuple(t.contiguous() for t in (r, J, err))
    dev = _check_cuda("wls_whiten_cuda", ts)
    r, J, err = ts
    batched = r.dim() == 2
    g = r.shape[0] if batched else 1
    n, p = J.shape[-2:]
    lead = (g,) if batched else ()
    if r.shape != lead + (n,) or J.dim() != r.dim() + 1 \
            or err.shape not in ((n,), lead + (n,)) or n == 0 or g == 0:
        raise ValueError("wls_whiten_cuda: r (N,) or (G, N), J (N, P) or "
                         "(G, N, P), err (N,) or as r, with N, G > 0")
    if p > K7_MAX_COLS or g > K7_MAX_POINTS:
        raise ValueError(f"wls_whiten_cuda: P = {p} > {K7_MAX_COLS} or "
                         f"G = {g} > {K7_MAX_POINTS}")
    f64 = dict(dtype=torch.float64, device=dev)
    partial = torch.empty((g, p + 1, K7.call("wls_whiten_tiles", n, p)),
                          **f64)
    rw = torch.empty(lead + (n,), **f64)
    Jn = torch.empty(lead + (n, p), **f64)
    norms = torch.empty(lead + (p,), **f64)
    chi2 = torch.empty(lead, **f64)
    K7.launch(dev, r.data_ptr(), J.data_ptr(), err.data_ptr(),
              partial.data_ptr(), rw.data_ptr(), Jn.data_ptr(),
              norms.data_ptr(), chi2.data_ptr(), g, n, p,
              n if err.dim() == 2 else 0)
    return rw, Jn, norms, chi2


@torch.library.custom_op("pint_tpu_torch::wls_whiten", mutates_args=(),
                         device_types="cpu")
def _wls_whiten_op(r: torch.Tensor, J: torch.Tensor, err: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    return wls_whiten_plain(r, J, err)


@_wls_whiten_op.register_kernel("cuda")
def _(r, J, err):
    return wls_whiten_cuda(r, J, err)


@_wls_whiten_op.register_fake
def _(r, J, err):
    return (r.new_empty(r.shape), J.new_empty(J.shape),
            J.new_empty(J.shape[:-2] + J.shape[-1:]),
            r.new_empty(r.shape[:-1]))


@_wls_whiten_op.register_vmap
def _(info, in_dims, r, J, err):
    """The points stack in front: (B, N) and (B, N, P) against an
    unbatched err (N,) are one K7 launch over B designs."""
    b = info.batch_size

    def front(x, d):
        return x.movedim(d, 0) if d is not None \
            else x.expand((b,) + x.shape)

    r, J = front(r, in_dims[0]), front(J, in_dims[1])
    lead, (n, p) = r.shape[:-1], J.shape[-2:]
    if in_dims[2] is None and err.dim() == 1:
        e2 = err
    else:
        e2 = front(err, in_dims[2]).expand(lead + (n,)).reshape(-1, n)
    rw, Jn, norms, chi2 = _wls_whiten_op(r.reshape(-1, n),
                                         J.reshape(-1, n, p), e2)
    return ((rw.reshape(lead + (n,)), Jn.reshape(lead + (n, p)),
             norms.reshape(lead + (p,)), chi2.reshape(lead)),
            (0, 0, 0, 0))


def wls_whiten(r, J, err):
    """The whitening pass: K7 for CUDA tensors, the plain version for
    CPU tensors.  Under ``torch.func.vmap`` a batch of points is one
    call (one launch)."""
    if r.device.type not in ("cuda", "cpu"):
        raise ValueError(f"wls_whiten: no version for {r.device}")
    return _wls_whiten_op(r, J, err)


# --------------------------------------------------------------------------
# streaming appends: the normal-equation summary and its rank-k updates
# (pint_tpu linalg.py:772-1000), and kernel K10
# --------------------------------------------------------------------------
#
# A bucket-interior append turns pad rows, weight ~1e-32, into real rows.
# woodbury_pre_append and noise_gram_append downdate the outgoing pad
# rows exactly, so they match a from-scratch precompute to roundoff.

class NormalBlocks(NamedTuple):
    """The GLS normal equations reduced to their N-free summary at one
    linearization point: everything the constant-gram path of
    :func:`gls_normal_solve` needs, with the O(N) row contractions done.
    Appended rows update it by row sums (:func:`normal_blocks_delta`), a
    step re-anchors it (:func:`normal_blocks_shift`), and
    :func:`normal_solve_from_blocks` solves it in O((P+K)^3)."""

    a_jj: torch.Tensor  # (P, P) J^T W J
    a_ju: torch.Tensor  # (P, K) J^T W U
    gram: torch.Tensor  # (K, K) U^T W U + Phi^-1
    y_j: torch.Tensor   # (P,)   J^T W r
    y_u: torch.Tensor   # (K,)   U^T W r
    rr: torch.Tensor    # ()     r^T W r


def normal_blocks(r, J, sigma, U, phi, valid=None):
    """:class:`NormalBlocks` from full-size arrays (pint_tpu
    linalg.py:795).  ``valid`` gives pad rows exactly zero weight; ``U``
    is dense or structured, ``phi`` a (K,) weight vector."""
    w = 1.0 / sigma**2
    if valid is not None:
        w = torch.where(valid, w, torch.zeros_like(w))
    nb = basis_ncols(U)
    Jw = J * w[:, None]
    a_jj = J.T @ Jw
    f64 = dict(dtype=torch.float64, device=J.device)
    if nb:
        a_ju = _ut_dot(U, Jw).T
        phi_inv, _ = _phi_terms(phi)
        gram = _weighted_gram(U, w) + phi_inv
        y_u = _ut_dot(U, w * r)
    else:
        a_ju = torch.zeros((J.shape[1], 0), **f64)
        gram = torch.zeros((0, 0), **f64)
        y_u = torch.zeros((0,), **f64)
    return NormalBlocks(a_jj=a_jj, a_ju=a_ju, gram=gram, y_j=Jw.T @ r,
                        y_u=y_u, rr=torch.sum(r * w * r))


def normal_blocks_delta(nb_pre: NormalBlocks, r_d, J_d, sigma_d, U_d,
                        valid_d=None):
    """Appended rows folded into a :class:`NormalBlocks` (pint_tpu
    linalg.py:838): every block is a row sum, so the rows add; rows off
    ``valid_d`` carry exactly zero weight.  ``U_d`` is the dense
    (DeltaN, K) basis rows of the new TOAs on the frozen basis."""
    w = 1.0 / sigma_d**2
    if valid_d is not None:
        w = torch.where(valid_d, w, torch.zeros_like(w))
    Jw = J_d * w[:, None]
    if nb_pre.gram.shape[0]:
        return NormalBlocks(
            a_jj=nb_pre.a_jj + J_d.T @ Jw,
            a_ju=nb_pre.a_ju + Jw.T @ U_d,
            gram=nb_pre.gram + U_d.T @ (U_d * w[:, None]),
            y_j=nb_pre.y_j + Jw.T @ r_d,
            y_u=nb_pre.y_u + U_d.T @ (w * r_d),
            rr=nb_pre.rr + torch.sum(r_d * w * r_d))
    return nb_pre._replace(a_jj=nb_pre.a_jj + J_d.T @ Jw,
                           y_j=nb_pre.y_j + Jw.T @ r_d,
                           rr=nb_pre.rr + torch.sum(r_d * w * r_d))


def normal_blocks_shift(nb_pre: NormalBlocks, dpar):
    """The blocks re-anchored after the parameters moved by ``dpar``
    (pint_tpu linalg.py:866): to first order r -> r + J dpar, so

        y_j += A_jj dpar,  y_u += A_ju^T dpar,
        rr  += 2 dpar^T y_j + dpar^T A_jj dpar."""
    rr = (nb_pre.rr + 2.0 * torch.dot(dpar, nb_pre.y_j)
          + dpar @ nb_pre.a_jj @ dpar)
    return nb_pre._replace(y_j=nb_pre.y_j + nb_pre.a_jj @ dpar,
                           y_u=nb_pre.y_u + nb_pre.a_ju.T @ dpar, rr=rr)


def normal_solve_from_blocks(nb_pre: NormalBlocks, with_health=False):
    """:func:`gls_normal_solve` from a :class:`NormalBlocks` (pint_tpu
    linalg.py:882, guard off): the same normalization, eigh cutoff and
    capacity-Cholesky chi^2 (``rr - y_u^T gram^-1 y_u``; ``rr`` without
    a basis).  Returns (dpar, cov, noise_coeffs, chi2[, SolveDiag]),
    dpar the step to ADD."""
    n_par = nb_pre.a_jj.shape[0]
    if nb_pre.gram.shape[0]:
        mtcm = torch.cat([torch.cat([nb_pre.a_jj, nb_pre.a_ju], dim=1),
                          torch.cat([nb_pre.a_ju.T, nb_pre.gram], dim=1)],
                         dim=0)
        rhs = torch.cat([nb_pre.y_j, nb_pre.y_u])
        chi2 = _gram_chi2(nb_pre.gram, nb_pre.rr, nb_pre.y_u)
    else:
        mtcm, rhs, chi2 = nb_pre.a_jj, nb_pre.y_j, nb_pre.rr
    return _normal_tail(mtcm, rhs, n_par, chi2, with_health)


def woodbury_pre_append(pre: WoodburyPre, row0, sigma_rows, u_rows):
    """A :class:`WoodburyPre` with rows ``[row0, row0 + DeltaN)`` (pad
    rows of a bucket) replaced by appended rows, without refactoring the
    N-row system (pint_tpu linalg.py:944): the capacity matrix moves by
    the rank-k difference of the outgoing and incoming rows,

        Sigma' = L L^T - U_old^T W_old U_old + U_new^T W_new U_new,

    re-Choleskied in O(K^3); logdet C moves by the white-row swap and
    the capacity determinant ratio."""
    dn = sigma_rows.shape[0]
    rows = torch.arange(row0, row0 + dn, device=pre.nvec.device)
    nvec_new = sigma_rows**2
    nvec_old = pre.nvec[row0:row0 + dn]
    u_old = basis_rows(pre.U, rows)
    cap = (pre.chol_lower @ pre.chol_lower.T
           - u_old.T @ (u_old / nvec_old[:, None])
           + u_rows.T @ (u_rows / nvec_new[:, None]))
    L = cho_factor(cap)
    logdet = (pre.logdet
              + torch.sum(torch.log(nvec_new)) - torch.sum(torch.log(nvec_old))
              + 2.0 * torch.sum(torch.log(torch.diagonal(L)))
              - 2.0 * torch.sum(torch.log(torch.diagonal(pre.chol_lower))))
    nvec = pre.nvec.clone()
    nvec[row0:row0 + dn] = nvec_new
    return WoodburyPre(nvec, basis_set_rows(pre.U, row0, u_rows), L, logdet,
                       L.T.contiguous())


def noise_gram_append(gram, sigma_rows, u_rows, sigma_old_rows,
                      u_old_rows):
    """A :func:`noise_gram_precompute` result with outgoing rows
    (``sigma_old_rows``, ``u_old_rows``: the pad rows an append turns
    real) swapped for the appended ones (pint_tpu linalg.py:977, whose
    unused ``row0`` argument is dropped): O(DeltaN K^2), no
    factorization."""
    w_new = 1.0 / sigma_rows**2
    w_old = 1.0 / sigma_old_rows**2
    return (gram - u_old_rows.T @ (u_old_rows * w_old[:, None])
            + u_rows.T @ (u_rows * w_new[:, None]))


#: kernel K10 (replaces the moment sums of pint_tpu linalg.py:795-866
#: and fitter.py:1196-1274: the stream capture and the append's fold)
K10 = CudaKernel(
    "stream_moments", "stream_moments.cu", "stream_moments_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4)
#: rows of A per split of K10's sum (csrc/stream_moments.cu K10_ROWS)
K10_ROWS = 96


def stream_moments_plain(S, A, w, c0=0):
    """``S += A^T diag(w) A[:, c0:]`` in place: S (c, c - c0) (a strided
    view is fine), A (n, c), w (n,).  The plain version of kernel K10,
    in its order: rows in splits of :data:`K10_ROWS`, each split's
    products ``(A[r, i] w[r]) A[r, c0 + j]`` summed in ascending row
    order, the splits' sums added in ascending order, the total added
    to S."""
    n, c = A.shape
    cw = c - c0
    ns = max(1, -(-n // K10_ROWS))
    # one split sums its n rows alone: the kernel's zero rows past n add
    # +0.0 to a sum that started at +0.0, which changes no bit
    rows = K10_ROWS if ns > 1 else n
    pad = ns * rows - n
    Aw = A * w[:, None]
    Aj = A[:, c0:]
    if pad:
        Aw = torch.cat([Aw, Aw.new_zeros((pad, c))])
        Aj = torch.cat([Aj, Aj.new_zeros((pad, cw))])
    X = Aw.reshape(ns, rows, c)
    Y = Aj.reshape(ns, rows, cw)
    acc = A.new_zeros((ns, c, cw))
    for r in range(rows):
        acc = acc + X[:, r, :, None] * Y[:, r, None, :]
    tot = acc[0]
    for s in range(1, ns):
        tot = tot + acc[s]
    S.add_(tot)
    return S


def stream_moments_cuda(S, A, w, c0=0):
    """Kernel K10 on CUDA tensors, in place (see
    :func:`stream_moments_plain`); raises on what it does not take."""
    A, w = A.contiguous(), w.contiguous()
    dev = _check_cuda("stream_moments_cuda", (S, A, w))
    n, c = A.shape if A.dim() == 2 else (0, 0)
    cw = c - c0
    if A.dim() != 2 or w.shape != (n,) or n == 0 or not 0 <= c0 < c \
            or S.shape != (c, cw) or S.stride(1) != 1 \
            or S.stride(0) < cw:
        raise ValueError("stream_moments_cuda: A (n, c), w (n,), S "
                         "(c, c - c0) with unit column stride, 0 <= c0 < c")
    ns = -(-n // K10_ROWS)
    partial = torch.empty((ns, c, cw) if ns > 1 else (0,),
                          dtype=torch.float64, device=dev)
    K10.launch(dev, A.data_ptr(), w.data_ptr(), S.data_ptr(),
               partial.data_ptr(), n, c, c0, S.stride(0))
    return S


def stream_moments(S, A, w, c0=0):
    """``S += A^T diag(w) A[:, c0:]`` in place: K10 for CUDA tensors,
    the plain version for CPU tensors."""
    if S.device.type == "cuda":
        return stream_moments_cuda(S, A, w, c0)
    if S.device.type == "cpu":
        return stream_moments_plain(S, A, w, c0)
    raise ValueError(f"stream_moments: no version for {S.device}")
