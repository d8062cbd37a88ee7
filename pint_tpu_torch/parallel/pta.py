"""PTA-scale batching: many pulsars, one batched program (pint_tpu
parallel/pta.py).

The per-pulsar WLS/GLS Gauss-Newton step is ``torch.func.vmap``-ped over
a padded pulsar axis, as ``grid.make_grid_fn`` vmaps a per-point refit:
every step of a whole-array fit is one set of calls whatever the member
count, the phase fold's kernel K1 over (k, n_max) ticks, kernel K7's
whitening of every pulsar's design (WLS) and the batched solves.  The
port's own code launches nothing per pulsar in a fit call.  Two library
calls do, inside cuSOLVER: the batched ``torch.linalg.svd`` of the
whitened (n_max, p) designs (WLS) and ``torch.linalg.eigh`` of the
(p + nb, p + nb) normal matrices (GLS) run one factorization a member
on the card, since cuSOLVER's batched Jacobi takes only matrices of 32
rows or fewer (ROADMAP queue 2, the batched small-matrix solve).

Padding: every pulsar is built with one component structure (the
superset of the batch's components, :func:`make_superset_models`: a
component a pulsar lacks is added with neutral values, its parameters
frozen, and switched off by its prepare-time ``__gate__``); the TOA
axis is padded to the batch maximum by repeating the last row, with
zero weight (error 1e30 s), and per-pulsar ctx arrays of other lengths
(mask stacks, epoch segments, Fourier combs) are zero-padded, which no
read of the batched fold sees.  The GLS noise basis is densified per
pulsar, with the mean-offset column, and zero-padded to a common width,
as the reference does: the segment layout of the single-pulsar path is
a per-pulsar structure that does not batch.  The basis is built at the
first GLS fit and its weights whenever a member's noise values change,
one member at a time (set-up, as the prepare is).

The batch runs on CUDA unless the caller passes ``device="cpu"``.  The
baseline rung of the reference's guard ladder is ported: a member whose
values, chi^2 or covariance come back non-finite is not written back,
and the call raises :class:`~pint_tpu_torch.fitter.FitDivergedError`
naming it.  Not ported, each raising ``NotImplementedError`` with its
ROADMAP queue 1 item: ``fit_wideband`` (10), ``mesh=`` and
``chisq_grid`` (13), ``checkpoint=``, the checkpoints and the jitter
rungs (2), ``optimal_statistic``/``common_process`` from a batch (8).
"""

from __future__ import annotations

import copy
import warnings
from typing import List, Sequence

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch.fitter import (FitDivergedError, guarded,
                                   resid_and_design, wls_gn_solve)
from pint_tpu_torch.fixedpoint import renorm_phase
from pint_tpu_torch.iterate import iterate_fixed
from pint_tpu_torch.linalg import (gls_normal_solve, su_to_dense,
                                   woodbury_solve)
from pint_tpu_torch.models.timing_model import DEFAULT_ORDER
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.toa import TOABatch

__all__ = ["PTABatch", "make_superset_models"]

#: error [s] of a padded TOA: its weight 1e-60 drops out of every sum
PAD_ERR_S = 1e30


def _unported(what, item):
    raise NotImplementedError(
        f"PTABatch: {what} is not ported yet (ROADMAP queue 1 item {item})")


def _pad_rows(a, n_max, axis=0):
    """``a`` padded to ``n_max`` along ``axis`` by repeating its last
    entry."""
    pad = n_max - a.shape[axis]
    if pad <= 0:
        return a
    reps = [1] * a.dim()
    reps[axis] = pad
    tail = a.narrow(axis, a.shape[axis] - 1, 1).repeat(reps)
    return torch.cat([a, tail], dim=axis)


def _pad_batch(batch: TOABatch, n_max) -> TOABatch:
    """Every TOA-axis array of ``batch`` padded to ``n_max`` by repeating
    the final row (padded rows get zero weight downstream)."""
    return TOABatch(
        ticks=_pad_rows(batch.ticks, n_max),
        freq_mhz=_pad_rows(batch.freq_mhz, n_max),
        error_s=_pad_rows(batch.error_s, n_max),
        ssb_obs_pos=_pad_rows(batch.ssb_obs_pos, n_max),
        ssb_obs_vel=_pad_rows(batch.ssb_obs_vel, n_max),
        obs_sun_pos=_pad_rows(batch.obs_sun_pos, n_max),
        # (n_bodies, N, 3): the TOA axis is padded even with no bodies
        planet_pos=_pad_rows(batch.planet_pos, n_max, axis=1))


def _batch_fields(batch):
    """A TOABatch as the tuple of its tensors (what ``vmap`` takes)."""
    return None if batch is None else (
        batch.ticks, batch.freq_mhz, batch.error_s, batch.ssb_obs_pos,
        batch.ssb_obs_vel, batch.obs_sun_pos, batch.planet_pos)


def _pad_ctx(ctx_map, n, n_max):
    """Prepare-time tensors whose last or first axis is the TOA axis,
    padded to ``n_max`` by repeating their last entry; everything else
    passes through."""
    out = {}
    for comp, ctx in ctx_map.items():
        c = {}
        for k, v in ctx.items():
            if isinstance(v, torch.Tensor) and v.dim() >= 1:
                if v.shape[-1] == n:
                    v = _pad_rows(v, n_max, axis=v.dim() - 1)
                elif v.shape[0] == n:
                    v = _pad_rows(v, n_max, axis=0)
            c[k] = v
        out[comp] = c
    return out


def _pad_to_shape(a, shape):
    """``a`` zero-padded up to ``shape`` along every axis."""
    if tuple(a.shape) == tuple(shape):
        return a
    out = torch.zeros(shape, dtype=a.dtype, device=a.device)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def _differs(a, b):
    if isinstance(a, float) and isinstance(b, float) and a != a and b != b:
        return False  # NaN sentinels agree
    return a != b


def _stack_ctxs(ctxs):
    """(stacked tensor part, static part) of per-pulsar ctx maps.  Tensor
    entries gain a leading pulsar axis, zero-padded to the elementwise
    largest shape where pulsars differ (ECORR epoch counts, mode counts,
    mask stacks: zero rows and columns are inert where the fold reads
    them).  Python entries must agree across pulsars and stay static;
    one that differs is host-side basis metadata the batched fold never
    reads, and is dropped with a warning so that a read of it fails."""
    arrays, static = {}, {}
    for comp in ctxs[0]:
        a, s = {}, {}
        for k, v0 in ctxs[0][comp].items():
            vals = [c[comp][k] for c in ctxs]
            if isinstance(v0, torch.Tensor):
                shapes = [tuple(v.shape) for v in vals]
                if len(set(shapes)) > 1:
                    if len({len(sh) for sh in shapes}) != 1:
                        raise ValueError(
                            f"ctx entry {comp}.{k} differs in rank across "
                            "the batch")
                    target = tuple(max(sh[i] for sh in shapes)
                                   for i in range(len(shapes[0])))
                    vals = [_pad_to_shape(v, target) for v in vals]
                a[k] = torch.stack(vals)
                continue
            if any(_differs(v, v0) for v in vals[1:]):
                warnings.warn(
                    f"per-pulsar static ctx entry {comp}.{k} dropped from "
                    "the batched ctx (host-side noise-basis metadata)")
                continue
            s[k] = v0
        arrays[comp] = a
        static[comp] = s
    return arrays, static


def _merge_ctx(arrays, static):
    """One pulsar's ctx map from its tensor part and the static part."""
    return {comp: {**static.get(comp, {}), **arrays[comp]}
            for comp in arrays}


#: placeholder values of parameters whose neutral default would divide by
#: zero or be NaN when a superset component is inert; log amplitudes go
#: deeply negative (0.0 would mean amplitude 1 and flood the GLS with
#: spurious variance: the gate covers delays and phases, not noise bases)
_SUPERSET_PLACEHOLDERS = {
    "PB": 365.25, "T0": 0.0, "TASC": 0.0,
    "TNREDAMP": -100.0, "TNDMAMP": -100.0, "TNCHROMAMP": -100.0,
}


def _structure(model):
    """What the batched fold bakes in: the component classes and their
    parameter names."""
    return (tuple(type(c).__name__ for c in model.components),
            tuple(sorted(p for c in model.components for p in c.params)))


def make_superset_models(pairs):
    """Every ``(model, toas[, tzr])`` rebuilt on the union of the
    batch's component classes (pint_tpu parallel/pta.py:210): a pulsar
    missing a component gets a copy of the widest instance of it, its
    values filled from the component's defaults, NaN replaced by
    ``_SUPERSET_PLACEHOLDERS`` (else 0), its parameters frozen, and its
    name in ``model._superset_inert``, which gives it a 0 gate at
    prepare.  A narrower member of a class with derivative terms
    (Spindown's F2..., DispersionDM's DM1...) takes the widest instance,
    the extra terms at 0; mask families of other widths raise.  The
    models are copies; components sort by category, then class name, so
    that every member has one order."""
    donors: dict = {}
    order: List = []
    for model, *_ in pairs:
        for c in model.components:
            cls = type(c)
            if cls not in donors:
                order.append(cls)
                donors[cls] = c
            elif len(c.params) > len(donors[cls].params):
                donors[cls] = c  # the widest family wins
    cat_order = {cat: i for i, cat in enumerate(DEFAULT_ORDER)}
    out = []
    for model, *rest in pairs:
        model = copy.deepcopy(model)
        have = {type(c) for c in model.components}
        inert = set()
        for cls in order:
            donor = donors[cls]
            if cls in have:
                mine = model.component(cls.__name__)
                if mine.params == donor.params:
                    continue
                if not set(mine.params) <= set(donor.params) \
                        or not hasattr(mine, "num_freq_derivs") \
                        and not hasattr(mine, "num_dm_derivs"):
                    raise NotImplementedError(
                        f"{cls.__name__}: members of the batch carry "
                        "different mask families; their superset "
                        "alignment is not ported yet (ROADMAP queue 1 "
                        "item 13)")
                wide = copy.deepcopy(donor)
                model.components[model.components.index(mine)] = wide
                for p in wide.params:
                    model.values.setdefault(
                        p, _SUPERSET_PLACEHOLDERS.get(p, 0.0))
                continue
            comp = copy.deepcopy(donor)
            model.components.append(comp)
            inert.add(cls.__name__)
            defaults = comp.defaults()
            for p in comp.params:
                cur = model.values.get(p, np.nan)
                if cur != cur:
                    cur = defaults.get(p, np.nan)
                if cur != cur:
                    cur = _SUPERSET_PLACEHOLDERS.get(p, 0.0)
                model.values[p] = float(cur)
        model._superset_inert = inert
        model.components.sort(key=lambda c: (cat_order.get(c.category, 99),
                                             type(c).__name__))
        out.append((model, *rest))
    return out


class PTABatch:
    """A batch of independently fit pulsars evaluated as one batched
    program.

    ``pairs``: ``[(model, toas), ...]`` or ``[(model, toas, tzr), ...]``
    (a TOATable with its TZR table, as :mod:`pint_tpu_torch.convert`
    gives them; ingest TOAs bring their own).  Members of different
    component structure are aligned by :func:`make_superset_models`."""

    def __init__(self, pairs: Sequence, device=None):
        if not pairs:
            raise ValueError("empty PTA batch")
        dev = resolve_device(device)
        if len({_structure(p[0]) for p in pairs}) != 1:
            pairs = make_superset_models(pairs)
        resids = []
        for model, toas, *tzr in pairs:
            resids.append(Residuals(toas, model,
                                    tzr=tzr[0] if tzr else None,
                                    device=dev, track_mode="nearest"))
        self._init_from_prepared([r.prepared for r in resids], resids)

    @classmethod
    def from_prepared(cls, prepareds, resids) -> "PTABatch":
        """A batch over already prepared pulsars, without the prepare
        pass (the serving layer's path).  The members must share one
        component structure; no superset alignment runs here.  One
        prepared pair may appear several times."""
        self = cls.__new__(cls)
        self._init_from_prepared(list(prepareds), list(resids))
        return self

    def _init_from_prepared(self, prepareds, resids):
        """Everything after the per-pulsar prepare: the free-name union,
        the padding and the stacking."""
        if len({_structure(p.model) for p in prepareds}) != 1:
            raise ValueError(
                "PTA batch: the prepared members carry different component "
                "structures; build the batch from (model, toas) pairs, "
                "which aligns them (make_superset_models)")
        self.prepareds = prepareds
        self.resids = resids
        self.device = prepareds[0].device
        # the union of the free parameters in first-appearance order; a
        # parameter outside a pulsar's own free list stays pinned at its
        # value (its design column is exactly zero)
        union: List[str] = []
        for p in prepareds:
            for n in p.model.free_params:
                if n not in union:
                    union.append(n)
        self.free_names = union
        self.free_mask = torch.tensor(
            [[1.0 if n in p.model.free_params else 0.0 for n in union]
             for p in prepareds], dtype=torch.float64, device=self.device)
        self.n_pulsars = len(prepareds)
        # one hybrid partition serves every member (one structure); no
        # frozen-delay leaves on the batched path, as in the reference
        self._partition = prepareds[0].design_partition(self.free_names)
        self.n_toas = np.asarray([len(p.batch) for p in prepareds])
        self.n_max = int(self.n_toas.max())
        self.batch = self._stack_batches([_pad_batch(p.batch, self.n_max)
                                          for p in prepareds])
        # the stacked fold closes over ONE static Kepler depth per
        # component: the shallow members deepen to the batch's largest
        # (exact, marginally slower for them)
        depth = max((sub["kepler_iters"] for p in prepareds
                     for m in (p.ctx, p.tzr_ctx) if m
                     for sub in m.values() if "kepler_iters" in sub),
                    default=0)
        if depth:
            for p in prepareds:
                for m in (p.ctx, p.tzr_ctx):
                    for sub in (m or {}).values():
                        if "kepler_iters" in sub:
                            sub["kepler_iters"] = depth
        self._stack_ctx_maps()
        tzr = [p.tzr_batch for p in prepareds]
        self.tzr_batch = (self._stack_batches(tzr)
                          if all(t is not None for t in tzr) else None)
        self.valid = (torch.arange(self.n_max, device=self.device)[None, :]
                      < torch.as_tensor(self.n_toas,
                                        device=self.device)[:, None])
        self._stack_values()
        self._U_pad = None
        self._phi = None  # (noise values' bytes, (k, nb_max) weights)
        #: the guard rung that served the last fit ("baseline", the one
        #: rung ported), None before a fit
        self.fit_rung = None

    def _stack_batches(self, batches):
        return TOABatch(*(torch.stack(xs) for xs in zip(
            *(_batch_fields(b) for b in batches))))

    def _stack_ctx_maps(self):
        ctxs = [_pad_ctx(p.ctx, len(p.batch), self.n_max)
                for p in self.prepareds]
        self.ctx, self.static_ctx = _stack_ctxs(ctxs)
        if all(p.tzr_ctx is not None for p in self.prepareds):
            self.tzr_ctx, self.static_tzr_ctx = _stack_ctxs(
                [p.tzr_ctx for p in self.prepareds])
        else:
            self.tzr_ctx, self.static_tzr_ctx = None, {}

    def _stack_values(self):
        """values0 (k, P) over the free union and base_values {name: (k,)}
        from the models, host-side in one pass."""
        vals = [p.model.values for p in self.prepareds]
        self.values0 = torch.tensor(
            [[float(v[n]) for n in self.free_names] for v in vals],
            dtype=torch.float64, device=self.device)
        names = list(vals[0])
        table = torch.tensor([[float(v[n]) for n in names] for v in vals],
                             dtype=torch.float64, device=self.device)
        self.base_values = {n: table[:, i] for i, n in enumerate(names)}

    # -- single-pulsar pure functions (vmapped below) -------------------------
    def _values_at(self, vec_or_sub, base_values, free_mask):
        """One pulsar's values at a free-parameter vector (or {name:
        value}): masked-out parameters stay at the pulsar's own value,
        so their design columns are exactly zero."""
        values = dict(base_values)
        for i, name in enumerate(self.free_names):
            v = (vec_or_sub[name] if isinstance(vec_or_sub, dict)
                 else vec_or_sub[i])
            values[name] = torch.where(free_mask[i] != 0, v,
                                       base_values[name])
        return values

    def _sigma_one(self, values, batch, ctx):
        """One pulsar's noise-scaled per-TOA sigma."""
        sigma = batch.error_s
        for c in self.prepareds[0].model.noise_components:
            sigma = c.scaled_sigma(values, batch, ctx[type(c).__name__],
                                   sigma)
        return sigma

    def _resid_one_values(self, values, batch, ctx, tzr_batch, tzr_ctx,
                          valid):
        """Mean-subtracted, pad-masked time residuals of one pulsar at a
        values dict."""
        p0 = self.prepareds[0]
        batch = TOABatch(*batch)
        ctx = _merge_ctx(ctx, self.static_ctx)
        n, frac = p0._phase_sum(values, batch, ctx)
        if tzr_batch is not None:
            tctx = _merge_ctx(tzr_ctx, self.static_tzr_ctx)
            tn, tfrac = p0._phase_sum(values, TOABatch(*tzr_batch), tctx)
            n = n - tn[0]
            frac = frac - tfrac[0]
        _, frac = renorm_phase(n, frac)
        resid = frac / values["F0"]
        # the weighted mean over the valid TOAs, EFAC/EQUAD-scaled weights
        sigma = self._sigma_one(values, batch, ctx)
        w = torch.where(valid, 1.0 / sigma ** 2, 0.0)
        mean = torch.sum(resid * w) / torch.sum(w)
        return torch.where(valid, resid - mean, 0.0)

    def _resid_one(self, vec, base_values, batch, ctx, tzr_batch, tzr_ctx,
                   valid, free_mask):
        return self._resid_one_values(
            self._values_at(vec, base_values, free_mask), batch, ctx,
            tzr_batch, tzr_ctx, valid)

    def _linear_cols_one(self, values, batch, ctx, tzr_batch, tzr_ctx,
                         valid, free_mask, lin):
        """Closed-form (n_max, L) time-residual design columns of one
        pulsar: the TZR columns subtracted, /F0, the valid-masked
        weighted mean removed, pad rows zero, pinned columns zero."""
        p0 = self.prepareds[0]
        batch = TOABatch(*batch)
        merged = _merge_ctx(ctx, self.static_ctx)
        cols = p0.linear_phase_columns(values, batch, merged, lin)
        if tzr_batch is not None:
            tz = _merge_ctx(tzr_ctx, self.static_tzr_ctx)
            tcols = p0.linear_phase_columns(values, TOABatch(*tzr_batch),
                                            tz, lin)
            cols = cols - tcols[0:1, :]
        cols = cols / values["F0"]
        sigma = self._sigma_one(values, batch, merged)
        w = torch.where(valid, 1.0 / sigma ** 2, 0.0)
        cols = cols - torch.sum(cols * w[:, None], dim=0) / torch.sum(w)
        cols = torch.where(valid[:, None], cols, 0.0)
        lin_idx = torch.as_tensor([self.free_names.index(p) for p in lin],
                                  device=cols.device)
        return cols * free_mask[lin_idx][None, :]

    def _rj_one(self, vec, base_values, batch, ctx, tzr_batch, tzr_ctx,
                valid, free_mask):
        """Hybrid (r, J) of one pulsar over the free union."""
        lin = self._partition[0]

        def resid_of(sub):
            return self._resid_one_values(
                self._values_at(sub, base_values, free_mask), batch, ctx,
                tzr_batch, tzr_ctx, valid)

        def linear_of(sub):
            return self._linear_cols_one(
                self._values_at(sub, base_values, free_mask), batch, ctx,
                tzr_batch, tzr_ctx, valid, free_mask, lin)

        return resid_and_design(tuple(self.free_names), vec,
                                self._partition, resid_of, linear_of)

    def _err_one(self, vec0, base_values, batch, ctx, valid):
        """Per-TOA sigma of one pulsar at its start, 1e30 s at pad rows."""
        values0 = dict(base_values)
        for i, name in enumerate(self.free_names):
            values0[name] = vec0[i]
        sigma = self._sigma_one(values0, TOABatch(*batch),
                                _merge_ctx(ctx, self.static_ctx))
        return torch.where(valid, sigma, PAD_ERR_S)

    def _fit_one(self, vec0, base_values, batch, ctx, tzr_batch, tzr_ctx,
                 valid, free_mask, maxiter):
        """One pulsar's WLS fit: ``maxiter`` Gauss-Newton steps, then
        chi^2 and covariance at the result (pint_tpu pta.py:609)."""
        err = self._err_one(vec0, base_values, batch, ctx, valid)

        def rj(v):
            return self._rj_one(v, base_values, batch, ctx, tzr_batch,
                                tzr_ctx, valid, free_mask)

        def body(vec):
            return vec + guarded(wls_gn_solve, *rj(vec), err)[0]

        vec = iterate_fixed(body, vec0, maxiter)
        _, chi2, cov, _ = guarded(wls_gn_solve, *rj(vec), err)
        return vec, chi2, cov

    def _fit_one_gls(self, vec0, base_values, batch, ctx, tzr_batch,
                     tzr_ctx, valid, free_mask, U, phi, maxiter):
        """One pulsar's GLS fit against its densified noise basis U and
        weights phi (pint_tpu pta.py:676)."""
        err = self._err_one(vec0, base_values, batch, ctx, valid)

        def rj(v):
            return self._rj_one(v, base_values, batch, ctx, tzr_batch,
                                tzr_ctx, valid, free_mask)

        def body(vec):
            return vec + guarded(gls_normal_solve, *rj(vec), err, U,
                                 phi)[0]

        vec = iterate_fixed(body, vec0, maxiter)
        _, cov, _, chi2 = guarded(gls_normal_solve, *rj(vec), err, U, phi)
        return vec, chi2, cov

    def _gather_noise(self):
        """(U (k, n_max, nb_max), phi (k, nb_max)): each pulsar's dense
        noise basis with the mean-offset column of ones, its weights at
        the current noise values (``MEAN_OFFSET_WEIGHT`` for the offset),
        zero-padded to one shape (zero columns are inert: the solve
        floors their weight).  The basis is built once, the weights again
        only when a member's noise values have changed since the last
        call: a fit at unchanged noise values reuses both."""
        key = np.asarray([float(p.model.values.get(n, np.nan))
                          for p in self.prepareds
                          for c in p.model.noise_components
                          for n in c.params]).tobytes()
        if self._phi is None or self._phi[0] != key:
            Us, phis = [], []
            for r in self.resids:
                su, phi = r._noise_basis_phi_at(r.prepared.values_dict())
                phis.append(phi)
                if self._U_pad is None:
                    Us.append(su_to_dense(su))
            nb_max = max(int(ph.shape[0]) for ph in phis)
            if self._U_pad is None:
                self._U_pad = torch.stack(
                    [_pad_to_shape(u, (self.n_max, nb_max)) for u in Us])
            self._phi = (key, torch.stack(
                [_pad_to_shape(ph, (nb_max,)) for ph in phis]))
        return self._U_pad, self._phi[1]

    # -- the batched fits -----------------------------------------------------
    def _build_fit(self, kind, maxiter):
        """The vmapped fit of every pulsar: (values0, base_values, batch,
        ctx, tzr_batch, tzr_ctx, valid, free_mask[, U, phi]) ->
        (vec (k, P), chi2 (k,), cov (k, P, P))."""
        tzr_ax = 0 if self.tzr_batch is not None else None
        tcx_ax = 0 if self.tzr_ctx is not None else None
        if kind == "wls":
            return torch.func.vmap(
                lambda v, b, bt, c, tb, tc, m, fm: self._fit_one(
                    v, b, bt, c, tb, tc, m, fm, maxiter),
                in_dims=(0, 0, 0, 0, tzr_ax, tcx_ax, 0, 0))
        return torch.func.vmap(
            lambda v, b, bt, c, tb, tc, m, fm, uu, ph: self._fit_one_gls(
                v, b, bt, c, tb, tc, m, fm, uu, ph, maxiter),
            in_dims=(0, 0, 0, 0, tzr_ax, tcx_ax, 0, 0, 0, 0))

    def _base_args(self):
        return (self.values0, self.base_values, _batch_fields(self.batch),
                self.ctx, _batch_fields(self.tzr_batch), self.tzr_ctx,
                self.valid, self.free_mask)

    def _run_batched(self, kind, maxiter, extra=()):
        """Run one batched fit and write back the genuinely free values
        of every member whose results are finite (one host copy)."""
        vec, chi2, cov = self._build_fit(kind, maxiter)(
            *self._base_args(), *extra)
        vec_np, chi2_np, cov_np = (t.detach().cpu().numpy()
                                   for t in (vec, chi2, cov))
        ok = (np.all(np.isfinite(vec_np), axis=1) & np.isfinite(chi2_np)
              & np.all(np.isfinite(cov_np), axis=(1, 2)))
        fm = self.free_mask.cpu().numpy()
        for k, p in enumerate(self.prepareds):
            if not ok[k]:
                continue  # never write a diverged member's values
            for i, name in enumerate(self.free_names):
                if fm[k, i]:
                    p.model.values[name] = float(vec_np[k, i])
        self.fit_rung = "baseline"
        bad = [int(i) for i in np.flatnonzero(~ok)]
        if bad:
            raise FitDivergedError(
                f"PTABatch: members {bad} came back non-finite; the others "
                "were written back, the listed ones kept their pre-fit "
                "values (the degradation ladder is not ported: ROADMAP "
                "queue 1 item 2)")
        return vec, chi2, cov

    def fit_wls(self, maxiter=3, mesh=None, checkpoint=None):
        """Batched WLS Gauss-Newton fit of every pulsar from ``values0``;
        returns (fitted values (k, P), chi2 (k,), cov (k, P, P)) and
        writes the free values back into the models."""
        self._check_options(mesh, checkpoint)
        while True:
            out = self._run_batched("wls", maxiter)
            if not self._kepler_depth_guard():
                return out

    def fit_gls(self, maxiter=3, mesh=None, checkpoint=None):
        """Batched GLS fit: every pulsar's timing parameters against its
        own correlated noise (ECORR and red-noise bases at the current
        noise values).  Returns and writes back as :meth:`fit_wls`."""
        self._check_options(mesh, checkpoint)
        while True:
            out = self._run_batched("gls", maxiter, self._gather_noise())
            if not self._kepler_depth_guard():
                return out

    @staticmethod
    def _check_options(mesh, checkpoint):
        if mesh is not None:
            _unported("mesh= (the pulsar axis over several cards)", 13)
        if checkpoint is not None:
            _unported("checkpoint=", 2)

    def fit_wideband(self, maxiter=3, mesh=None, checkpoint=None):
        _unported("fit_wideband", 10)

    def chisq_grid(self, grid_params, grid_values, n_steps=2, mesh=None):
        _unported("chisq_grid", 13)

    def save_checkpoint(self, path):
        _unported("save_checkpoint", 2)

    def restore_checkpoint(self, path):
        _unported("restore_checkpoint", 2)

    def optimal_statistic(self, **kwargs):
        _unported("an OptimalStatistic from a batch", 8)

    def common_process(self, **kwargs):
        _unported("a CommonProcess from a batch", 8)

    def _kepler_depth_guard(self):
        """After write-back: when a member's fitted eccentricity left the
        prepare-time depth class, every member deepens to the new
        harmonized depth and the caller refits (the depth is monotone
        over four classes).  True when the fit must run again."""
        from pint_tpu_torch.models.binary.kepler import newton_iters_for

        reaches = [r for r in (p.kepler_ecc_reach() for p in self.prepareds)
                   if r != float("-inf")]
        if not reaches:
            return False
        worst = max(reaches, key=newton_iters_for)
        # a list, not any(): every member must deepen
        if not any([p.ensure_kepler_depth(worst) for p in self.prepareds]):
            return False
        warnings.warn(
            "batched fit moved an eccentricity reach to %.3g, past the "
            "prepare-time Kepler depth class; deepening the Newton unroll "
            "and refitting the batch" % worst)
        self._restack_after_depth_change()
        return True

    def _restack_after_depth_change(self):
        """The stacked ctx rebuilt after ``ensure_kepler_depth`` changed
        the members' ctx, and the start values from the written-back
        models."""
        self._stack_ctx_maps()
        self._stack_values()

    # -- evaluation without a fit ---------------------------------------------
    def _eval(self, one, values):
        vals = (self.values0 if values is None else torch.as_tensor(
            values, dtype=torch.float64, device=self.device))
        tzr_ax = 0 if self.tzr_batch is not None else None
        tcx_ax = 0 if self.tzr_ctx is not None else None
        f = torch.func.vmap(one, in_dims=(0, 0, 0, 0, tzr_ax, tcx_ax, 0, 0))
        return f(vals, *self._base_args()[1:])

    def residuals(self, values=None):
        """(k, n_max) padded time residuals at stacked free-parameter rows
        ``values`` (default ``values0``), zero at pad rows, as a tensor on
        the batch's device."""
        return self._eval(self._resid_one, values)

    def residuals_shared(self, values=None):
        """:meth:`residuals` as a numpy array (the serving layer's
        residual op)."""
        return self.residuals(values).detach().cpu().numpy()

    def _chisq_one(self, vec, base_values, batch, ctx, tzr_batch, tzr_ctx,
                   valid, free_mask):
        """One pulsar's white-noise chi^2 at a free-parameter vector, no
        refit: correlated noise enters only through the scaled sigmas."""
        values = self._values_at(vec, base_values, free_mask)
        r = self._resid_one_values(values, batch, ctx, tzr_batch, tzr_ctx,
                                   valid)
        sigma = self._sigma_one(values, TOABatch(*batch),
                                _merge_ctx(ctx, self.static_ctx))
        err = torch.where(valid, sigma, PAD_ERR_S)
        return torch.sum((r / err) ** 2)

    def chisq(self, values=None):
        """(k,) weighted chi^2 at stacked free-parameter rows ``values``
        ((k, P); default ``values0``), no fit, as a numpy array."""
        return self._eval(self._chisq_one, values).detach().cpu().numpy()

    def _sigma_cinv_r(self, kind, values=None):
        """(sigma, C^-1 r), (k, n_max) numpy arrays, at stacked
        free-parameter rows ``values`` (default ``values0``): the
        noise-scaled sigma (``PAD_ERR_S`` at pad rows) and r / sigma^2
        (``kind`` "wls") or the Woodbury solve of r against each
        member's noise basis ("gls"), what
        ``tolerances.pta_chi2_limit`` reads."""
        r = self.residuals(values)
        sigma = self._eval(
            lambda v, b, bt, c, tb, tc, m, fm: self._err_one(v, b, bt, c, m),
            None)
        if kind == "wls":
            cinv_r = r / sigma ** 2
        else:
            U, phi = self._gather_noise()
            cinv_r = torch.func.vmap(woodbury_solve)(sigma, U, phi, r)
        return sigma.cpu().numpy(), cinv_r.cpu().numpy()

    @property
    def dof(self):
        return self.n_toas - len(self.free_names) - 1

    def sky_positions(self):
        """(k, 3) SSB -> pulsar unit vectors."""
        from pint_tpu_torch.gw.orf import pulsar_positions

        return pulsar_positions([p.model for p in self.prepareds])
