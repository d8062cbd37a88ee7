"""Gauss-Newton fitters (pint_tpu fitter.py: ``resid_and_design``,
``wls_gn_solve``, the ``Fitter`` base, ``WLSFitter`` and ``GLSFitter``
at their baseline rung).

Each iteration builds the hybrid design matrix — closed-form columns
for the phase-linear parameters, ``torch.func.jacfwd`` over the
nonlinear rest (it composes through the ``autograd.Function``s around
kernel K1 and the Kepler solve) — and solves for the step:
:class:`GLSFitter` through the noise-augmented normal equations,
:class:`WLSFitter` through the SVD of the whitened, column-normalized
design (whitening by kernel K7 on CUDA).  With no free noise parameter,
sigma (and for GLS phi and the (K, K) noise gram) are constants of the
fit, built once; the delays of frozen components are computed once too.

The fitters take a :class:`~pint_tpu_torch.toa.TOATable` with its TZR
table, or ingest :class:`~pint_tpu_torch.toa.TOAs` (the TZR TOA then
comes from the model).  Not ported: the guard's degradation ladder.  A
non-finite chi^2 raises :class:`FitDivergedError`, and ``model.values``
is never written with non-finite results.

Streaming appends (pint_tpu fitter.py:179-320, :1092-1615): with
``bucket=True`` the TOAs are padded to their size bucket
(:mod:`pint_tpu_torch.compile_cache`); after a fit, ``stream_prepare()``
captures the raw weighted moments of the linearization (the one O(N)
pass) and ``append_refit(night)`` folds a night of new TOAs into them as
a rank-DeltaN update (kernel K10) and solves, with no O(N) pass while
the night fits the bucket.  The moments are kept as one packed symmetric
matrix (:class:`StreamMoments`), the JAX package's names as views of it.
"""

from __future__ import annotations

import copy
import math
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from pint_tpu_torch import compile_cache as _cc
from pint_tpu_torch import resolve_device
from pint_tpu_torch.linalg import (NormalBlocks, SolveDiag, basis_ncols,
                                   basis_rows, gls_normal_solve,
                                   noise_gram_append, noise_gram_precompute,
                                   normal_solve_from_blocks,
                                   segment_sum_fixed_order, stream_moments,
                                   wls_whiten)
from pint_tpu_torch.models.timing_model import PreparedModel
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.toa import TOAs


class FitDivergedError(RuntimeError):
    """A Gauss-Newton step produced a non-finite chi^2."""


def resid_and_design(free, vec, partition, resid_of, linear_of):
    """(r, J) at the free-parameter vector ``vec``: the analytic columns
    for the linear names, ``jacfwd`` over the nonlinear remainder,
    gathered back into free order."""
    lin, nl = partition
    free = tuple(free)
    full = {name: vec[i] for i, name in enumerate(free)}
    r = resid_of(full)
    if not lin:
        def resid_fn(v):
            return resid_of({name: v[i] for i, name in enumerate(free)})

        return r, torch.func.jacfwd(resid_fn)(vec)
    idx = {name: i for i, name in enumerate(free)}
    J_lin = linear_of(full)
    if nl:
        nl_idx = torch.as_tensor([idx[p] for p in nl], device=vec.device)

        def resid_nl(nv):
            sub = dict(full)
            for j, p in enumerate(nl):
                sub[p] = nv[j]
            return resid_of(sub)

        J_nl = torch.func.jacfwd(resid_nl)(vec[nl_idx])
        blocks = torch.cat([J_nl, J_lin], dim=1)
    else:
        blocks = J_lin
    order = {p: j for j, p in enumerate(tuple(nl) + tuple(lin))}
    perm = [order[p] for p in free]
    if perm == list(range(len(free))):
        return r, blocks
    return r, blocks[:, torch.as_tensor(perm, device=vec.device)] \
        .contiguous()


#: singular values at or below this times the largest are dropped from the
#: WLS step (pint_tpu fitter.py:124's default)
WLS_SVD_THRESHOLD = 1e-14


def wls_gn_solve(r, J, err):
    """One whitened, column-normalized SVD Gauss-Newton step (pint_tpu
    fitter.py:124, guard off).  Returns (dpar, chi2 at the input, cov,
    SolveDiag): singular values at or below ``WLS_SVD_THRESHOLD`` times
    the largest are dropped, and the diagnostics count them
    (``n_truncated``) and give log10 of the largest over the smallest
    kept (``cond_log10``).  The whitening pass is kernel K7 on CUDA;
    the SVD is ``torch.linalg.svd``."""
    rw, Jn, norms, chi2 = wls_whiten(r, J, err)
    U, s, Vt = torch.linalg.svd(Jn, full_matrices=False)
    smax = torch.max(s)
    keep = s > WLS_SVD_THRESHOLD * smax
    s_inv = torch.where(keep, 1.0 / s, torch.zeros_like(s))
    dpar = -((Vt.T * s_inv[None, :]) @ (U.T @ rw)) / norms
    cov = ((Vt.T * s_inv[None, :] ** 2) @ Vt) / torch.outer(norms, norms)
    kept_min = torch.min(torch.where(keep, s, smax))
    diag = SolveDiag(
        n_truncated=torch.sum(~keep).to(torch.int32),
        cond_log10=torch.log10(smax / torch.clamp(kept_min, min=1e-300)))
    return dpar, chi2, cov, diag


def guarded(solve, r, J, err, *noise, **kw):
    """``solve(r, J, err, *noise, **kw)`` with its inputs replaced by
    zeros (ones for err and for a 1-D noise input such as phi, the
    identity for a keyword matrix such as ``gram``) and its tensor
    outputs by NaN when any tensor input is non-finite.  torch's SVD and
    eigh raise ``LinAlgError`` on a non-finite matrix where the
    reference's solve returns NaN; with the guard a non-finite step
    gives a NaN chi^2, which the fit turns into
    :class:`FitDivergedError` and a downhill fitter counts as worse.
    Under ``vmap`` (the PTA batch) each member is guarded on its own.
    A non-tensor input (a structured basis, a flag) passes through.
    Finite inputs pass through bit for bit."""
    tensors = [r, J, err] + [t for t in list(noise) + list(kw.values())
                             if isinstance(t, torch.Tensor)]
    ok = torch.isfinite(tensors[0]).all()
    for t in tensors[1:]:
        ok = ok & torch.isfinite(t).all()

    def fill(t, v):
        return torch.where(ok, t, torch.full_like(t, v))

    noise = tuple(fill(t, 0.0 if t.dim() == 2 else 1.0)
                  if isinstance(t, torch.Tensor) else t for t in noise)
    kw = {k: torch.where(ok, t, torch.eye(t.shape[-1], dtype=t.dtype,
                                          device=t.device))
          if isinstance(t, torch.Tensor) else t for k, t in kw.items()}
    out = solve(fill(r, 0.0), fill(J, 0.0), fill(err, 1.0), *noise, **kw)
    return tuple(fill(o, float("nan")) if isinstance(o, torch.Tensor)
                 else o for o in out)


# -- streaming appends (module helpers) -------------------------------------
#
# An appended night touches the normal equations only through row sums,
# so DeltaN new TOAs are a rank-DeltaN update.  The fitter keeps RAW
# (uncentered) weighted moments of the current linearization and derives
# the mean-centered NormalBlocks at solve time: the weighted-mean
# subtraction (appending rows moves the mean, which moves every row's
# residual) becomes a rank-one correction instead of an O(N) re-read.

#: padded block of an append's delta rows (pint_tpu's
#: $PINT_TPU_STREAM_BLOCK default): every night of up to this many TOAs
#: is evaluated at one shape
STREAM_BLOCK = 32
#: anomaly-triage threshold in whitened sigma (its
#: $PINT_TPU_STREAM_TRIAGE_SIGMA default)
STREAM_TRIAGE_SIGMA = 7.0
#: incremental refits between full moment captures (its
#: $PINT_TPU_STREAM_RECAPTURE default): the refit linearizes at the
#: capture point and shifts the moments to first order after each step,
#: so a recapture re-anchors the Jacobian
STREAM_RECAPTURE = 8


class StreamMoments:
    """Raw (uncentered) weighted moments of the current linearization,
    packed as one symmetric matrix (pint_tpu fitter.py:232
    ``_StreamMoments``).

    With q the residual and Jq its design evaluated WITHOUT the mean
    subtraction, w = 1/sigma^2, U the extended noise basis (K columns,
    the mean-offset column last) and Phi its prior, ``S`` is A^T W A +
    diag(Phi^-1, 0) for A = [U | Jq | q | 1], (K + P + 2) square.  The
    JAX package's ten moments are views of it.  Only ``S[:, K:]`` and
    ``S[:K, :K]`` are read: the fold (kernel K10) adds the whole
    A^T W A, the capture fills what is read."""

    def __init__(self, S, k, p):
        self.S, self.k, self.p = S, k, p

    @property
    def g_uu(self):   # (K, K) U^T W U + Phi^-1
        return self.S[:self.k, :self.k]

    @property
    def a_qu(self):   # (P, K) Jq^T W U
        return self.S[:self.k, self.k:self.k + self.p].T

    @property
    def a_qq(self):   # (P, P) Jq^T W Jq
        k, p = self.k, self.p
        return self.S[k:k + p, k:k + p]

    @property
    def b_u(self):    # (K,) U^T W q
        return self.S[:self.k, self.k + self.p]

    @property
    def b_q(self):    # (P,) Jq^T W q
        k, p = self.k, self.p
        return self.S[k:k + p, k + p]

    @property
    def rr(self):     # () q^T W q
        i = self.k + self.p
        return self.S[i, i]

    @property
    def s_u(self):    # (K,) U^T W 1
        return self.S[:self.k, self.k + self.p + 1]

    @property
    def s_j(self):    # (P,) Jq^T W 1
        k, p = self.k, self.p
        return self.S[k:k + p, k + p + 1]

    @property
    def s_q(self):    # () 1^T W q
        i = self.k + self.p
        return self.S[i, i + 1]

    @property
    def s_w(self):    # () 1^T W 1
        i = self.k + self.p + 1
        return self.S[i, i]


def _derive_blocks(m: StreamMoments, center) -> NormalBlocks:
    """Mean-centered :class:`~pint_tpu_torch.linalg.NormalBlocks` from
    raw moments (pint_tpu fitter.py:253): removing the weighted mean
    S_x / S_w from two row vectors turns their weighted product sum into
    S_xy - S_x S_y / S_w.  Only the residual and design side centers; U
    stays raw (its mean-offset column carries the mean)."""
    if not center:
        return NormalBlocks(a_jj=m.a_qq, a_ju=m.a_qu, gram=m.g_uu,
                            y_j=m.b_q, y_u=m.b_u, rr=m.rr)
    c = 1.0 / m.s_w
    return NormalBlocks(
        a_jj=m.a_qq - c * torch.outer(m.s_j, m.s_j),
        a_ju=m.a_qu - c * torch.outer(m.s_j, m.s_u),
        gram=m.g_uu,
        y_j=m.b_q - c * m.s_j * m.s_q,
        y_u=m.b_u - c * m.s_u * m.s_q,
        rr=m.rr - c * m.s_q ** 2)


def _quarantine_rows(delta, rows):
    """A copy of an append's delta with ``rows`` made zero-weight: they
    keep their slot and flags, gain ``-quarantine 1`` and carry
    ``PAD_ERROR_US``, so no weighted reduction sees them (pint_tpu
    fitter.py:295)."""
    out = delta[np.arange(len(delta))]
    out.error_us = np.asarray(out.error_us, dtype=np.float64).copy()
    out.error_us[rows] = _cc.PAD_ERROR_US
    for i in rows:
        out.flags[int(i)]["quarantine"] = "1"
    return out


class _MiniAppend(NamedTuple):
    """One append's delta prepared as a tiny padded dataset: the
    O(DeltaN) surface for the delta rows' residuals, design rows, sigma
    and frozen-delay entries (pint_tpu fitter.py:309)."""

    toas: object
    prep: object
    res: object
    data: dict
    block: int   # padded block length


class Fitter:
    """The Gauss-Newton loop shared by the fitters: ``Fitter(toas,
    model, tzr=None, device=None).fit_toas(maxiter=3)`` runs on CUDA
    unless ``device`` names another device.  Subclasses define
    ``_step``.  ``bucket=True`` pads ingest TOAs to their size bucket
    (the streaming appends need it)."""

    #: whether the step reads the frozen-noise (phi, gram) leaves; every
    #: step reads sigma
    _noise_gram_leaves = False

    def __init__(self, toas, model, tzr=None, device=None, bucket=False):
        self.device = resolve_device(device)
        self.model = model
        if bucket:
            if not isinstance(toas, TOAs):
                raise ValueError("bucket=True pads ingest TOAs; a TOATable "
                                 "cannot be padded")
            toas = _cc.pad_toas(toas)
        self.resids = Residuals(toas, model, tzr=tzr, device=self.device)
        #: the ingest TOAs when given (appends merge into them), else the
        #: table
        self.toas = toas if isinstance(toas, TOAs) else self.resids.toas
        self.prepared = self.resids.prepared
        self.covariance: Optional[np.ndarray] = None
        self.chi2_iters: list = []
        self.fit_health = None
        #: incremental-refit state, None when no capture is live
        self._stream = None
        #: what the streaming path did: captures, appends (incremental),
        #: reprepares, refits, solve fallbacks
        self.stream_counts = dict.fromkeys(
            ("captures", "appends", "reprepares", "refits",
             "solve_fallbacks"), 0)
        self._retrace()

    # -- setup ----------------------------------------------------------------
    def _retrace(self):
        """Recompute the structure of the step for the current free set:
        the frozen-delay components and their leaves, the hybrid
        partition, the frozen-noise leaves."""
        self._traced_free = tuple(self.model.free_timing_params)
        self._fit_data = self._partition_setup()

    def _partition_setup(self):
        free = self._traced_free
        prep = self.prepared
        self._frozen_names = prep.frozen_delay_split(free)
        self._partition = prep.design_partition(free,
                                                frozen=self._frozen_names)
        frozen, tzr_frozen = prep.frozen_delay_leaves(self._frozen_names)
        data = {}
        if frozen is not None:
            data["frozen"] = frozen
            if tzr_frozen is not None:
                data["tzr_frozen"] = tzr_frozen
        self._noise_owned = sorted(p for c in prep.model.noise_components
                                   for p in c.params)
        self._noise_frozen = set(self._noise_owned).isdisjoint(free)
        if self._noise_frozen:
            data.update(self._noise_leaves())
        self._leaves_fp = self._fingerprint()
        return data

    def _fingerprint(self):
        """The values the precomputed leaves were built from: an edit to
        a frozen delay or noise parameter between fits re-folds them."""
        vals = self.prepared.frozen_param_values(self._frozen_names)
        if self._noise_frozen:
            vals.update({k: float(self.model.values.get(k, np.nan))
                         for k in self._noise_owned})
        return vals

    @staticmethod
    def _fp_same(a, b):
        """NaN-tolerant {param: value} fingerprint equality."""
        return a.keys() == b.keys() and all(
            v == b[k] or (v != v and b[k] != b[k]) for k, v in a.items())

    def _refresh_leaves(self):
        if not self._fp_same(self._fingerprint(), self._leaves_fp):
            self._fit_data = self._partition_setup()

    def _noise_leaves(self):
        """sigma (and for GLS phi and the (K, K) noise gram) at the
        current values."""
        with torch.no_grad():
            base = self.prepared.values_dict()
            sigma = self.resids.sigma_at(base)
            if not self._noise_gram_leaves:
                return {"noise_sigma": sigma}
            U, phi = self.resids._noise_basis_phi_at(base)
            return {"noise_sigma": sigma, "noise_phi": phi,
                    "noise_gram": noise_gram_precompute(sigma, U, phi)}

    # -- one Gauss-Newton step --------------------------------------------------
    def _merged(self, base_values, vec):
        values = dict(base_values)
        for i, name in enumerate(self._traced_free):
            values[name] = vec[i]
        return values

    def _rj(self, vec, base_values, data):
        def resid_of(sub):
            values = dict(base_values)
            values.update(sub)
            return self.resids.time_resids_at(values, data)

        def linear_of(sub):
            values = dict(base_values)
            values.update(sub)
            return self.resids.linear_design_at(values, self._partition[0],
                                                data)

        return resid_and_design(self._traced_free, vec, self._partition,
                                resid_of, linear_of)

    def _iterate(self, maxiter):
        vec = torch.tensor([self.model.values[k] for k in self._traced_free],
                           dtype=torch.float64, device=self.device)
        base = self.prepared.values_dict()
        chi2_prev = None
        cov = None
        diag = None
        self.chi2_iters = []
        for _ in range(maxiter):
            dpar, chi2, cov, diag = self._step(vec, base, self._fit_data)
            vec_new = vec + dpar
            chi2_f = float(chi2)
            if not np.isfinite(chi2_f):
                raise FitDivergedError(
                    f"non-finite chi2 at iteration {len(self.chi2_iters)}")
            self.chi2_iters.append(chi2_f)
            vec = vec_new
            if chi2_prev is not None and \
                    abs(chi2_prev - chi2_f) < 1e-8 * max(chi2_f, 1.0):
                break
            chi2_prev = chi2_f
        return vec, cov, diag

    # -- the fit ----------------------------------------------------------------
    def fit_toas(self, maxiter=3) -> float:
        """Iterate Gauss-Newton steps; write back values and
        uncertainties; return the chi^2 at the fitted values."""
        if not self.model.free_timing_params:
            raise ValueError("no free timing parameters to fit")
        if tuple(self.model.free_timing_params) != self._traced_free:
            self._retrace()
        else:
            self._refresh_leaves()
        # Kepler depth classes are monotone (4 -> 6 -> 8 -> 10): at most
        # three refits
        for _ in range(4):
            vec, cov, diag = self._iterate(maxiter)
            vec_np = vec.detach().cpu().numpy()
            cov_np = cov.detach().cpu().numpy()
            if not (np.all(np.isfinite(vec_np))
                    and np.all(np.isfinite(np.diag(cov_np)))):
                raise FitDivergedError("non-finite fitted parameters")
            errs = np.sqrt(np.clip(np.diag(cov_np), 0, None))
            for i, name in enumerate(self._traced_free):
                self.model.values[name] = float(vec_np[i])
                self.model.uncertainties[name] = float(errs[i])
            self.covariance = cov_np
            self.fit_health = {
                "n_truncated": int(diag.n_truncated),
                "cond_log10": float(diag.cond_log10)}
            if not self._kepler_depth_guard():
                break
        return self.resids.chi2

    # -- streaming appends ----------------------------------------------------
    def _stream_check(self):
        if not isinstance(self.toas, TOAs):
            raise NotImplementedError(
                "streaming appends merge into ingest TOAs; this fitter was "
                "given a TOATable")

    def _stream_raw_view(self):
        """A shallow copy of the residuals without the mean subtraction:
        the stream keeps RAW moments and centers them at solve time."""
        raw = copy.copy(self.resids)
        raw.subtract_mean = False
        return raw

    def _stream_rj(self, res, data):
        """(q, Jq) of residuals ``res`` at the current parameters."""
        vec = torch.tensor([self.model.values[k] for k in self._traced_free],
                           dtype=torch.float64, device=self.device)
        base = self.prepared.values_dict()

        def resid_of(sub):
            values = dict(base)
            values.update(sub)
            return res.time_resids_at(values, data)

        def linear_of(sub):
            values = dict(base)
            values.update(sub)
            return res.linear_design_at(values, self._partition[0], data)

        q, jq = resid_and_design(self._traced_free, vec, self._partition,
                                 resid_of, linear_of)
        return q, jq, base

    def _stream_capture_inputs(self):
        """(A, w, kd) of the capture's K10 call: A = [U_dense | Jq | q |
        1] at the current parameters (raw), w = 1/sigma^2 of the
        frozen-noise leaf, kd the dense basis width (0 for WLS).  The
        mean-offset column (U's last) is the ones column of A."""
        data = self._fit_data
        q, jq, _ = self._stream_rj(self._stream_raw, data)
        w = 1.0 / data["noise_sigma"] ** 2
        one = torch.ones((jq.shape[0], 1), dtype=torch.float64,
                         device=self.device)
        cols = [jq, q[:, None], one]
        if self._noise_gram_leaves:
            U = self.resids._U_ext
            cols = [U.pre, U.post[:, :-1]] + cols
        A = torch.cat(cols, dim=1)
        return A, w, A.shape[1] - jq.shape[1] - 2

    def _stream_capture(self) -> StreamMoments:
        """The one O(N) pass: raw moments at the current parameters.
        K10 sums [U_dense | Jq | q | 1]^T W [Jq | q | 1] in one pass over
        the rows; K2's segment sums give the ECORR rows; g_uu is the
        frozen-noise gram leaf itself, so capture and batch step see the
        same gram (pint_tpu fitter.py:1196)."""
        data = self._fit_data
        with torch.no_grad():
            A, w, kd = self._stream_capture_inputs()
            p = len(self._traced_free)
            X = torch.zeros((kd + p + 2, p + 2), dtype=torch.float64,
                            device=self.device)
            stream_moments(X, A, w, kd)
            if not self._noise_gram_leaves:
                return StreamMoments(X, 0, p)
            U = self.resids._U_ext
            k = basis_ncols(U)
            k_pre, k_e = U.pre.shape[1], U.k_e
            tail = A[:, kd:]
            S = torch.zeros((k + p + 2, k + p + 2), dtype=torch.float64,
                            device=self.device)
            S[:k, :k] = data["noise_gram"]
            S[:k_pre, k:] = X[:k_pre]
            if k_e:
                S[k_pre:k_pre + k_e, k:] = segment_sum_fixed_order(
                    tail * w[:, None], U.perm, U.offsets)
            S[k_pre + k_e:k - 1, k:] = X[k_pre:kd]
            S[k - 1, k:] = X[-1]
            S[k:, k:] = X[kd:]
            return StreamMoments(S, k, p)

    def stream_prepare(self) -> StreamMoments:
        """Capture the streaming state at the current parameters
        (normally right after a converged ``fit_toas``).  Needs the
        frozen-noise path: with a free noise parameter an append changes
        sigma and phi on every row and nothing is incremental."""
        self._stream_check()
        if not self._noise_frozen:
            raise NotImplementedError(
                "streaming refit requires the frozen-noise path (no free "
                "noise parameters)")
        self._stream_raw = self._stream_raw_view()
        m = self._stream_capture()
        self._stream = {"moments": m, "since_capture": 0,
                        "fp": dict(self._leaves_fp)}
        self.stream_counts["captures"] += 1
        return m

    def _stream_mini_build(self, delta) -> _MiniAppend:
        """An append's delta as a tiny padded dataset (pint_tpu
        fitter.py:1123): padded to ``STREAM_BLOCK`` rows; the TZR anchor
        is the BASE prepare's (a mini-local one would shift every delta
        phase by the TZR difference); each correlated component's ctx is
        an empty basis (the merged prepare owns the epochs)."""
        block = STREAM_BLOCK
        n_t = block if len(delta) <= block else _cc.bucket_size(len(delta))
        mtoas = _cc.pad_toas(delta, n_target=n_t)
        mprep = PreparedModel(self.model, mtoas.to_table(), None,
                              self.device)
        mprep.tzr_batch = self.prepared.tzr_batch
        mprep.tzr_ctx = self.prepared.tzr_ctx
        for c in self.model.noise_components:
            if c.introduces_correlated_errors:
                mprep.ctx[type(c).__name__] = {
                    "basis": torch.zeros((n_t, 0), dtype=torch.float64,
                                         device=self.device),
                    "counts": ()}
        mprep._noise_basis_comps = []
        mres = Residuals(mtoas, self.model, prepared=mprep,
                         subtract_mean=False,
                         track_mode=self.resids.track_mode)
        data = {}
        if self._frozen_names:
            frozen, tzr_frozen = mprep.frozen_delay_leaves(
                self._frozen_names)
            if frozen is not None:
                data["frozen"] = frozen
                if tzr_frozen is not None:
                    data["tzr_frozen"] = tzr_frozen
        return _MiniAppend(toas=mtoas, prep=mprep, res=mres, data=data,
                           block=n_t)

    def _stream_delta(self, mini):
        """(q, Jq, sigma) of the delta block at the current parameters,
        raw, on the mini dataset."""
        with torch.no_grad():
            q, jq, base = self._stream_rj(mini.res, mini.data)
            sigma = mini.res.sigma_at(base)
        return q, jq, sigma

    def _stream_refit(self, m: StreamMoments, q_d, j_d, sigma_d, u_d,
                      valid_d):
        """The rank-DeltaN fold (K10, in place), the solve, and the
        first-order re-anchor of the moments (pint_tpu fitter.py:1245):
        O((P+K)^2 DeltaN + (P+K)^3), no term in N.  ``valid_d`` gives the
        block padding and quarantined rows exactly zero weight.  Returns
        (dpar, cov, chi2, SolveDiag, centering): ``centering`` is the
        largest ratio of a raw to a centered diagonal entry of the design
        block, the factor by which centering loses precision."""
        with torch.no_grad():
            w = torch.where(valid_d, 1.0 / sigma_d ** 2,
                            torch.zeros_like(sigma_d))
            one = torch.ones((q_d.shape[0], 1), dtype=torch.float64,
                             device=self.device)
            stream_moments(m.S, torch.cat([u_d, j_d, q_d[:, None], one],
                                          dim=1), w, 0)
            blocks = _derive_blocks(m, bool(self.resids.subtract_mean))
            dpar, cov, _ncoef, chi2, diag = normal_solve_from_blocks(
                blocks, with_health=True)
            centering = torch.max(torch.diagonal(m.a_qq)
                                  / torch.diagonal(blocks.a_jj))
            # q(theta + dpar) = q + Jq dpar in the linear model
            # (normal_blocks_shift on the raw moments)
            rr = m.rr + 2.0 * torch.dot(dpar, m.b_q) + dpar @ m.a_qq @ dpar
            b_q = m.b_q + m.a_qq @ dpar
            b_u = m.b_u + m.a_qu.T @ dpar
            s_q = m.s_q + torch.dot(m.s_j, dpar)
            m.b_q.copy_(b_q)
            m.b_u.copy_(b_u)
            m.rr.copy_(rr)
            m.s_q.copy_(s_q)
        return dpar, cov, chi2, diag, centering

    def _stream_triage(self, q, sigma, t_s, threshold):
        """Triage of an arriving night, whitened against the PRE-append
        fit (pint_tpu fitter.py:1323): scattered rows past ``threshold``
        are quarantined one by one ("outlier"); a one-sided excursion of
        most of the night quarantines the whole night ("glitch", or
        "acceleration" when it trends in time).  Returns {verdict, z,
        outliers, quarantine, threshold, margin}: ``margin`` is the
        smallest | |z| - threshold | of the night, how near a row came to
        the other decision."""
        m = self._stream["moments"]
        s_w = float(m.s_w)
        mu = float(m.s_q) / s_w if s_w > 0 else 0.0
        z = (np.asarray(q) - mu) / np.asarray(sigma)
        out = np.abs(z) > threshold
        outliers = np.flatnonzero(out)
        verdict, quarantine = "clean", outliers
        if outliers.size:
            one_sided = bool(np.all(z[out] > 0) or np.all(z[out] < 0))
            if len(z) >= 3 and out.mean() >= 0.5 and one_sided:
                tc = t_s - t_s.mean()
                zc = z - z.mean()
                denom = np.sqrt((tc ** 2).sum() * (zc ** 2).sum())
                slope = abs(float((tc * zc).sum() / denom)) \
                    if denom > 0 else 0.0
                verdict = "acceleration" if slope > 0.8 else "glitch"
                quarantine = np.arange(len(z))
            else:
                verdict = "outlier"
            warnings.warn(
                f"stream triage: {verdict} signature in appended TOAs "
                f"({outliers.size}/{len(z)} rows beyond "
                f"{threshold:.1f} sigma); {quarantine.size} rows "
                "quarantined")
        return {"verdict": verdict, "z": z, "outliers": outliers,
                "quarantine": np.asarray(quarantine, dtype=np.int64),
                "threshold": float(threshold),
                "margin": float(np.min(np.abs(np.abs(z) - threshold)))}

    def _row0(self):
        return self.toas.n_filled or self.toas.n_real or len(self.toas)

    def append(self, delta, quarantine=(), _mini=None) -> bool:
        """Merge ``delta`` into the (padded) dataset (pint_tpu
        fitter.py:1363): incrementally when it fits the bucket (pad rows
        turn real, the ctx and basis take the new rows on the device, the
        frozen-delay and sigma leaves are patched from the mini dataset,
        the noise gram by a rank-DeltaN row swap), otherwise by a full
        re-prepare at the next bucket, which drops the stream.  True on
        the incremental path.  ``quarantine`` lists delta rows held out
        of every solve (zero-weight, flagged ``-quarantine 1``)."""
        self._stream_check()
        dn = len(delta)
        row0 = self._row0()
        quarantine = np.unique(np.asarray(quarantine, dtype=np.int64)
                               .ravel()) if np.size(quarantine) \
            else np.zeros(0, dtype=np.int64)
        if quarantine.size and (quarantine[0] < 0 or quarantine[-1] >= dn):
            raise ValueError("quarantine indices outside the delta")
        if quarantine.size:
            delta = _quarantine_rows(delta, quarantine)
        merged, in_bucket = _cc.append_toas(self.toas, delta)
        if quarantine.size:
            pv = merged.pad_valid
            if pv is None:
                nf = merged.n_filled or len(merged)
                pv = np.arange(len(merged)) < nf
            pv = np.asarray(pv, dtype=bool).copy()
            pv[row0 + quarantine] = False
            merged.pad_valid = pv
        resids = None
        if in_bucket:
            prepared = self.prepared.prepare_appended(
                merged, row0,
                mini_ctx=_mini.prep.ctx if _mini is not None else None)
            if prepared is not None:
                resids = Residuals(merged, self.model, prepared=prepared,
                                   subtract_mean=self.resids.subtract_mean,
                                   track_mode=self.resids.track_mode)
                if resids.structure_key() != self.resids.structure_key():
                    # a static of the ctx changed under the new span
                    # (e.g. the Kepler depth): re-prepare in full
                    resids = None
        if resids is None:
            self.stream_counts["reprepares"] += 1
            self.toas = merged
            self.resids = Residuals(merged, self.model, device=self.device,
                                    subtract_mean=self.resids.subtract_mean,
                                    track_mode=self.resids.track_mode)
            self.prepared = self.resids.prepared
            self._stream = None
            self._retrace()
            return False
        self.stream_counts["appends"] += 1
        old_data, old_u = self._fit_data, self.resids._U_ext
        self.toas = merged
        self.resids = resids
        self.prepared = resids.prepared
        if tuple(self.model.free_timing_params) != self._traced_free:
            self._stream = None
            self._retrace()
            return True
        mini = _mini if _mini is not None else self._stream_mini_build(delta)
        self._append_fit_data(old_data, old_u, mini, row0, dn, quarantine)
        if self._stream is not None:
            self._stream_raw = self._stream_raw_view()
        return True

    def _append_fit_data(self, old, old_u, mini, row0, dn, quarantine):
        """O(DeltaN) refresh of the fit data after an in-bucket append
        (pint_tpu fitter.py:1471): the new rows' frozen delays and sigma
        from the mini dataset, written on the device; the noise gram by
        :func:`~pint_tpu_torch.linalg.noise_gram_append` (pad rows out,
        real rows in).  Rows past the delta keep their old pad values
        (weight ~1e-44)."""
        data = {}
        rows = torch.arange(row0, row0 + dn, device=self.device)
        if "frozen" in old:
            frozen = {}
            for name, arr in old["frozen"].items():
                a = arr.clone()
                a[row0:row0 + dn] = mini.data["frozen"][name][:dn]
                frozen[name] = a
            data["frozen"] = frozen
            if "tzr_frozen" in old:
                data["tzr_frozen"] = old["tzr_frozen"]
        if self._noise_frozen:
            with torch.no_grad():
                sig_rows = mini.res.sigma_at(
                    self.prepared.values_dict())[:dn].clone()
            if quarantine.size:
                # the sentinel, as the reference stamps it
                sig_rows[torch.as_tensor(quarantine, device=self.device)] \
                    = _cc.PAD_ERROR_US * 1e-6
            sigma = old["noise_sigma"].clone()
            old_sig_rows = sigma[row0:row0 + dn].clone()
            sigma[row0:row0 + dn] = sig_rows
            data["noise_sigma"] = sigma
            if self._noise_gram_leaves:
                data["noise_phi"] = old["noise_phi"]
                data["noise_gram"] = noise_gram_append(
                    old["noise_gram"], sig_rows,
                    basis_rows(self.resids._U_ext, rows), old_sig_rows,
                    basis_rows(old_u, rows))
        self._fit_data = data

    def append_refit(self, delta, triage_sigma=None, maxiter=3) -> dict:
        """The streaming ingest (pint_tpu fitter.py:1517): triage the
        night against the pre-append fit, append it, and refit by the
        rank-DeltaN fold of the captured moments, with no O(N) pass.  A
        full fit (and a fresh capture) at a bucket boundary, after the
        stream was dropped, and when the incremental solve is not finite
        (the reference's rule; it checks results, it catches nothing).
        Returns {mode ("incremental" | "reprepare" | "refit_full" |
        "fallback"), triage, chi2 (at the pre-step vector on the
        incremental path), dpar, in_bucket, and on the incremental path
        the refit's cond_log10 and centering ratio}."""
        self._stream_check()
        dn = len(delta)
        if self._stream is None:
            self.stream_prepare()
        elif not self._fp_same(self._fingerprint(), self._stream["fp"]):
            # a frozen or noise parameter was edited since the capture
            self._refresh_leaves()
            self.stream_prepare()
        row0 = self._row0()
        mini = self._stream_mini_build(delta)
        q_b, j_b, sigma_b = self._stream_delta(mini)
        thresh = STREAM_TRIAGE_SIGMA if triage_sigma is None \
            else triage_sigma
        t_s = np.asarray(mini.toas.ticks[:dn], dtype=np.float64) / 2.0 ** 32
        tri = self._stream_triage(q_b[:dn].cpu().numpy(),
                                  sigma_b[:dn].cpu().numpy(), t_s, thresh)
        in_bucket = self.append(delta, quarantine=tri["quarantine"],
                                _mini=mini)
        if not in_bucket or self._stream is None:
            mode = "reprepare" if not in_bucket else "refit_full"
            chi2 = self.fit_toas(maxiter=maxiter)
            self.stream_prepare()
            return {"mode": mode, "triage": tri, "chi2": chi2, "dpar": None,
                    "in_bucket": in_bucket, "cond_log10": None,
                    "centering": None}
        m = self._stream["moments"]
        u_b = torch.zeros((mini.block, m.k), dtype=torch.float64,
                          device=self.device)
        if m.k:
            u_b[:dn] = basis_rows(self.resids._U_ext,
                                  torch.arange(row0, row0 + dn,
                                               device=self.device))
        valid = np.zeros(mini.block, dtype=bool)
        valid[:dn] = True
        valid[tri["quarantine"]] = False
        dpar, cov, chi2, diag, centering = self._stream_refit(
            m, q_b, j_b, sigma_b, u_b, torch.as_tensor(valid,
                                                       device=self.device))
        dpar_np = dpar.cpu().numpy()
        cov_np = cov.cpu().numpy()
        chi2_f = float(chi2)
        if not (np.isfinite(chi2_f) and np.isfinite(dpar_np).all()
                and np.isfinite(cov_np).all()):
            self.stream_counts["solve_fallbacks"] += 1
            self._stream = None
            chi2 = self.fit_toas(maxiter=maxiter)
            self.stream_prepare()
            return {"mode": "fallback", "triage": tri, "chi2": chi2,
                    "dpar": None, "in_bucket": True, "cond_log10": None,
                    "centering": None}
        errs = np.sqrt(np.clip(np.diag(cov_np), 0.0, None))
        for i, name in enumerate(self._traced_free):
            self.model.values[name] = float(self.model.values[name]
                                            + dpar_np[i])
            self.model.uncertainties[name] = float(errs[i])
        self.covariance = cov_np
        self._stream["since_capture"] += 1
        self.stream_counts["refits"] += 1
        cond = float(diag.cond_log10)
        if self._stream["since_capture"] >= STREAM_RECAPTURE:
            self.stream_prepare()
        return {"mode": "incremental", "triage": tri, "chi2": chi2_f,
                "dpar": dpar_np, "in_bucket": True,
                "cond_log10": cond if math.isfinite(cond) else None,
                "centering": float(centering)}

    def _kepler_depth_guard(self):
        """After write-back: deepen the static Newton depth when the
        fitted eccentricity left the prepare-time class; True when the
        fit must run again."""
        reach = self.prepared.kepler_ecc_reach()
        if reach == float("-inf"):
            return False
        if not self.prepared.ensure_kepler_depth(reach):
            return False
        self._retrace()
        return True


class WLSFitter(Fitter):
    """Weighted least squares: the SVD of the whitened, column-normalized
    design matrix (pint_tpu fitter.py:1620), whitened by the
    noise-scaled uncertainties (EFAC/EQUAD)."""

    def _step(self, vec, base_values, data):
        """(dpar, chi2 at vec, cov, SolveDiag)."""
        if self._noise_frozen:
            sigma = data["noise_sigma"]
        else:
            sigma = self.resids.sigma_at(self._merged(base_values, vec))
        r, J = self._rj(vec, base_values, data)
        return guarded(wls_gn_solve, r, J, sigma)


class GLSFitter(Fitter):
    """Generalized least squares over the low-rank noise basis."""

    _noise_gram_leaves = True

    def _step(self, vec, base_values, data):
        """(dpar, chi2 at vec, cov, SolveDiag)."""
        values = self._merged(base_values, vec)
        if self._noise_frozen:
            sigma = data["noise_sigma"]
            U, phi = self.resids._U_ext, data["noise_phi"]
            gram = data["noise_gram"]
        else:
            sigma = self.resids.sigma_at(values)
            U, phi = self.resids._noise_basis_phi_at(values)
            gram = None
        r, J = self._rj(vec, base_values, data)
        dpar, cov, _ncoef, chi2, diag = guarded(
            gls_normal_solve, r, J, sigma, U, phi, gram=gram,
            with_health=True)
        return dpar, chi2, cov, diag
