"""Residuals: observed-minus-model phase and time residuals (pint_tpu
residuals.py), nearest-pulse tracking with weighted-mean subtraction.

chi^2 goes through the Woodbury identity over the noise basis, which is
always carried as a :class:`~pint_tpu_torch.linalg.StructuredU`: dense
columns before the ECORR block (``pre``), the epoch block as segments,
dense columns after it (``post``), and a unit column at weight
``MEAN_OFFSET_WEIGHT`` absorbing the mean that the residuals subtract.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch.linalg import (StructuredU, structured_from_blocks,
                                   woodbury_chi2_logdet)

#: prior variance of the synthetic constant-offset column (pint_tpu
#: keeps 1e30 where the reference used 1e40; kept: it changes the
#: answer)
MEAN_OFFSET_WEIGHT = 1e30


def weighted_mean_phase(frac, weights):
    return torch.sum(frac * weights) / torch.sum(weights)


class Residuals:
    """Residuals bound to (toas, model) on ``device`` (CUDA unless
    given).  ``tzr`` is the one-row TZR table, or None; ingest
    :class:`~pint_tpu_torch.toa.TOAs` bring their own (see
    ``TimingModel.tables``).  ``subtract_mean=False`` keeps the weighted
    mean in (the simulation's phase inversion)."""

    def __init__(self, toas, model, tzr=None, device=None,
                 subtract_mean=True):
        toas, tzr = model.tables(toas, tzr)
        self.toas = toas
        self.device = resolve_device(device)
        self.prepared = model.prepare(toas, tzr=tzr, device=self.device)
        self.model = model
        self.subtract_mean = subtract_mean
        self._U_ext = self._build_structured_U()

    def _build_structured_U(self) -> StructuredU:
        """The extended noise basis as a StructuredU: dense blocks on
        either side of the (at most one) ECORR component's epochs, the
        mean-offset column appended."""
        prep = self.prepared
        n = len(self.toas)
        ecorrs = [c for c in prep._noise_basis_comps
                  if c.category == "ecorr_noise"]
        if len(ecorrs) > 1:
            raise NotImplementedError(
                "more than one ECORR component: the dense-basis fallback "
                "is not ported")
        pre, post = [], []
        seg, k_e = np.zeros(n, dtype=np.int64), 0
        side = pre
        for c in prep._noise_basis_comps:
            ctx = prep.ctx[type(c).__name__]
            if c.category == "ecorr_noise":
                seg = ctx["seg"].cpu().numpy()
                k_e = c.n_basis(ctx)
                side = post
            else:
                side.append(ctx["basis"].cpu().numpy())
        post.append(np.ones((n, 1)))

        def cat(blocks):
            return (np.concatenate(blocks, axis=1) if blocks
                    else np.zeros((n, 0)))

        return structured_from_blocks(cat(pre), seg, k_e, cat(post),
                                      self.device)

    # -- pure functions of values ---------------------------------------------
    def sigma_at(self, values):
        """Noise-scaled per-TOA uncertainty [s]."""
        return self.prepared.scaled_sigma_fn(values)

    def phase_resids_at(self, values, data=None):
        """Nearest-pulse phase residuals [turns], weighted mean removed.
        ``data`` may carry precomputed frozen-component delays
        (``frozen``/``tzr_frozen``)."""
        data = data or {}
        prep = self.prepared
        _, frac = prep._phase_raw_at(
            values, prep.batch, prep.ctx, prep.tzr_batch, prep.tzr_ctx,
            frozen=data.get("frozen"), tzr_frozen=data.get("tzr_frozen"))
        if not self.subtract_mean:
            return frac
        w = 1.0 / self.sigma_at(values) ** 2
        return frac - weighted_mean_phase(frac, w)

    def time_resids_at(self, values, data=None):
        return self.phase_resids_at(values, data) / values["F0"]

    def linear_design_at(self, values, names, data=None):
        """(N, L) time-residual design columns for the phase-linear
        ``names`` — the analytic half of the hybrid design matrix, with
        the TZR column subtracted, the /F0 conversion and the
        weighted-mean subtraction jacfwd of time_resids_at would
        apply."""
        data = data or {}
        prep = self.prepared
        cols = prep.linear_phase_columns(values, prep.batch, prep.ctx,
                                         names, frozen=data.get("frozen"))
        if prep.tzr_batch is not None:
            tcols = prep.linear_phase_columns(
                values, prep.tzr_batch, prep.tzr_ctx, names,
                frozen=data.get("tzr_frozen"))
            cols = cols - tcols[0:1, :]
        cols = cols / values["F0"]
        w = 1.0 / self.sigma_at(values) ** 2
        return cols - torch.sum(cols * w[:, None], dim=0) / torch.sum(w)

    def _noise_basis_phi_at(self, values):
        """(U, phi) for the Woodbury paths, the mean-offset weight
        appended."""
        phi = torch.cat([self.prepared.noise_weights_fn(values), torch.full(
            (1,), MEAN_OFFSET_WEIGHT, dtype=torch.float64,
            device=self.device)])
        return self._U_ext, phi

    def chi2_at(self, values):
        r = self.time_resids_at(values)
        sigma = self.sigma_at(values)
        if not self.model.has_correlated_errors:
            return torch.sum((r / sigma) ** 2)
        U, phi = self._noise_basis_phi_at(values)
        chi2, _ = woodbury_chi2_logdet(r, sigma, U, phi)
        return chi2

    # -- host accessors --------------------------------------------------------
    @property
    def time_resids(self) -> np.ndarray:
        v = self.prepared.values_dict()
        return self.time_resids_at(v).detach().cpu().numpy()

    @property
    def chi2(self) -> float:
        return float(self.chi2_at(self.prepared.values_dict()))

    @property
    def ecorr_segment_cols(self) -> int:
        """Epoch count carried through segment sums."""
        return self._U_ext.k_e
