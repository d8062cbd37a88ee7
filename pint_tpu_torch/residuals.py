"""Residuals: observed-minus-model phase and time residuals (pint_tpu
residuals.py) with weighted-mean subtraction, under either track mode:
nearest-pulse tracking (each TOA's phase to its nearest integer, after
any ``PHASE``-command offset), or tracking by the ``-pn`` pulse numbers
the TOAs carry (``TRACK -2``), whose integer part is differenced in
int64 so that 10^11-turn counts stay exact.

chi^2 goes through the Woodbury identity over the noise basis, which is
always carried as a :class:`~pint_tpu_torch.linalg.StructuredU`: dense
columns before the ECORR block (``pre``), the epoch block as segments,
dense columns after it (``post``), and a unit column at weight
``MEAN_OFFSET_WEIGHT`` absorbing the mean that the residuals subtract.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch.linalg import woodbury_chi2_logdet

#: prior variance of the synthetic constant-offset column (pint_tpu
#: keeps 1e30 where the reference used 1e40; kept: it changes the
#: answer)
MEAN_OFFSET_WEIGHT = 1e30


def weighted_mean_phase(frac, weights):
    return torch.sum(frac * weights) / torch.sum(weights)


def _resolve_track_mode(track_mode, model, pn):
    """The track mode (pint_tpu residuals.py:84-111): an explicit
    ``track_mode`` first, then the par's TRACK -2 / 0, then pulse numbers
    when every TOA carries one.  Raises ValueError on an unknown mode and
    on pulse-number tracking without a complete set of pulse numbers."""
    if track_mode is None or track_mode == "auto":
        track = model.meta.get("TRACK", "")
        if track == "-2":
            track_mode = "use_pulse_numbers"
        elif track == "0":
            track_mode = "nearest"
        elif pn is not None and not np.any(np.isnan(pn)):
            track_mode = "use_pulse_numbers"
        else:
            track_mode = "nearest"
    if track_mode == "pulse_number":
        track_mode = "use_pulse_numbers"
    if track_mode not in ("nearest", "use_pulse_numbers"):
        raise ValueError(f"unknown track_mode {track_mode!r}")
    if track_mode == "use_pulse_numbers":
        if pn is None:
            raise ValueError(
                "track_mode requires pulse numbers but the TOAs carry no "
                "-pn flags (use toas.compute_pulse_numbers)")
        if np.any(np.isnan(pn)):
            raise ValueError("Pulse numbers are missing on some TOAs")
    return track_mode


class Residuals:
    """Residuals bound to (toas, model) on ``device`` (CUDA unless
    given).  ``tzr`` is the one-row TZR table, or None; ingest
    :class:`~pint_tpu_torch.toa.TOAs` bring their own (see
    ``TimingModel.tables``).  ``subtract_mean=False`` keeps the weighted
    mean in (the simulation's phase inversion).  ``track_mode`` is
    "nearest" or "use_pulse_numbers" ("pulse_number" is accepted); None
    resolves it as pint_tpu does (residuals.py:84-111): the par's
    ``TRACK -2`` or ``TRACK 0`` first, else pulse numbers when every TOA
    carries ``-pn``, else nearest."""

    def __init__(self, toas, model, tzr=None, device=None,
                 subtract_mean=True, prepared=None, track_mode=None):
        # bucketing (pint_tpu_torch.compile_cache.pad_toas): pad rows
        # past n_real carry ~zero weight; the dof and the likelihood's
        # count use the real rows, and its logdet masks the pad rows.
        # Padded TOAs always carry the mask (all true at a bucket
        # boundary); a quarantine hole makes it explicit (pad_valid)
        self.n_real = getattr(toas, "n_real", None) or len(toas)
        valid = None
        if getattr(toas, "pad_valid", None) is not None:
            valid = np.asarray(toas.pad_valid, dtype=bool)
            self.n_real = int(np.count_nonzero(valid))
        elif getattr(toas, "n_real", None) is not None:
            valid = np.arange(len(toas)) < self.n_real
        self.device = resolve_device(device if prepared is None
                                     else prepared.device)
        if prepared is None:
            toas, tzr = model.tables(toas, tzr)
            prepared = model.prepare(toas, tzr=tzr, device=self.device)
        self.prepared = prepared
        self.toas = prepared.toas
        self.model = model
        self.subtract_mean = subtract_mean
        self._valid = None if valid is None else torch.as_tensor(
            valid, device=self.device)
        self._U_ext = prepared.structured_basis()
        pn = self.toas.get_pulse_numbers()
        self.track_mode = _resolve_track_mode(track_mode, model, pn)
        #: int64 pulse numbers under use_pulse_numbers, else None
        self._pn = None
        if self.track_mode == "use_pulse_numbers":
            self._pn = torch.as_tensor(pn.astype(np.int64),
                                       device=self.device)
        dpn = self.toas.get_delta_pulse_numbers()
        #: PHASE-command offsets [turns], None when all zero
        self._dpn = torch.as_tensor(dpn, dtype=torch.float64,
                                    device=self.device) \
            if np.any(dpn != 0.0) else None

    def structure_key(self):
        """What the step computes besides data (the port's counterpart
        of pint_tpu's trace key, residuals.py:224): the component set,
        each ctx's static entries (the Kepler depth, ECORR counts, the
        comb's df), the noise basis widths, the mean convention and the
        presence of the pad mask, the track mode and the presence of
        pulse numbers and PHASE offsets.  Shapes alone never decide."""
        prep = self.prepared
        statics = tuple(
            (name, k, repr(v)) for name, ctx in prep.ctx.items()
            for k, v in sorted(ctx.items())
            if not isinstance(v, torch.Tensor))
        widths = tuple((type(c).__name__, c.n_basis(prep.ctx[type(c).__name__]))
                       for c in prep._noise_basis_comps)
        return (tuple(type(c).__name__ for c in self.model.components),
                statics, widths, self.subtract_mean,
                self._valid is not None, self.track_mode,
                self._pn is not None, self._dpn is not None)

    @property
    def dof(self) -> int:
        return self.n_real - len(self.model.free_params) - int(
            self.subtract_mean)

    # -- pure functions of values ---------------------------------------------
    def sigma_at(self, values):
        """Noise-scaled per-TOA uncertainty [s]."""
        return self.prepared.scaled_sigma_fn(values)

    def phase_resids_at(self, values, data=None):
        """Phase residuals [turns] under the track mode, weighted mean
        removed (pint_tpu residuals.py:313-331).  ``data`` may carry
        precomputed frozen-component delays (``frozen``/``tzr_frozen``)."""
        data = data or {}
        prep = self.prepared
        n, frac = prep._phase_raw_at(
            values, prep.batch, prep.ctx, prep.tzr_batch, prep.tzr_ctx,
            frozen=data.get("frozen"), tzr_frozen=data.get("tzr_frozen"))
        if self._pn is not None:
            # model phase minus the assigned pulse number, the integers
            # first: a float64 turn count would round at 4e11 turns
            resid = (n - self._pn).to(torch.float64) + frac
            if self._dpn is not None:
                resid = resid + self._dpn
        else:
            resid = frac
            if self._dpn is not None:
                # PHASE commands shift the phase before the nearest-
                # integer assignment
                resid = resid + self._dpn
                resid = resid - torch.round(resid)
        if not self.subtract_mean:
            return resid
        w = 1.0 / self.sigma_at(values) ** 2
        return resid - weighted_mean_phase(resid, w)

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
        if not self.subtract_mean:
            return cols
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

    def lnlikelihood_at(self, values):
        """Gaussian log-likelihood of the residuals under the full noise
        covariance (pint_tpu residuals.py:391): -(chi2 + logdet C) / 2 -
        n log(2 pi) / 2, the white branch with logdet C = 2 sum log
        sigma, the correlated one through :func:`woodbury_chi2_logdet`.
        Bucketing pad rows are masked out of the white logdet (their log
        sigma would bias a noise fit) and n counts the real TOAs."""
        r = self.time_resids_at(values)
        sigma = self.sigma_at(values)
        if not self.model.has_correlated_errors:
            chi2 = torch.sum((r / sigma) ** 2)
            logs = torch.log(sigma)
            if self._valid is not None:
                logs = torch.where(self._valid, logs, torch.zeros_like(logs))
            logdet = 2.0 * torch.sum(logs)
        else:
            U, phi = self._noise_basis_phi_at(values)
            chi2, logdet = woodbury_chi2_logdet(r, sigma, U, phi,
                                                valid=self._valid)
        return -0.5 * (chi2 + logdet) - 0.5 * self.n_real * math.log(
            2.0 * math.pi)

    def lnlikelihood(self, values=None) -> float:
        """:meth:`lnlikelihood_at` at ``values`` (a {name: float} dict;
        the model's values when None), as a host float."""
        return float(self.lnlikelihood_at(self.prepared.values_dict(values)))

    # -- host accessors --------------------------------------------------------
    @property
    def phase_resids(self) -> np.ndarray:
        v = self.prepared.values_dict()
        return self.phase_resids_at(v).detach().cpu().numpy()

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
