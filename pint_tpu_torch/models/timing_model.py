"""TimingModel and PreparedModel (pint_tpu models/timing_model.py).

A slim host-side :class:`TimingModel` holds the ordered components, the
float64 values, the exact ``epoch_ticks`` and the free parameters.
``model.prepare(toas, tzr, device)`` binds it to a TOA table: every
component's ctx is built once on ``device``, the TZR row gets its own
ctx, and the pure functions below evaluate the delay fold, the phase
fold and the TZR-referenced phase from a ``{name: 0-d tensor}`` values
dict.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from pint_tpu_torch import fixedpoint as fp
from pint_tpu_torch import resolve_device
from pint_tpu_torch.models.component import (Component, DelayComponent,
                                             PhaseComponent)

#: evaluation order by category (pint_tpu DEFAULT_ORDER, the part the
#: ported components use; unknown categories sort last)
DEFAULT_ORDER = [
    "astrometry",
    "solar_system_shapiro",
    "dispersion_constant",
    "pulsar_system",
    "absolute_phase",
    "spindown",
]


class TimingModel:
    """Components + values + exact epochs + free parameters (host)."""

    def __init__(self, components=(), values=None, epoch_ticks=None,
                 free_params=(), name=""):
        self.name = name
        order = {cat: i for i, cat in enumerate(DEFAULT_ORDER)}
        self.components: List[Component] = sorted(
            components, key=lambda c: order.get(c.category, 99))
        self.values: Dict[str, float] = dict(values or {})
        self.epoch_ticks: Dict[str, int] = dict(epoch_ticks or {})
        self.free_params: List[str] = list(free_params)
        self.uncertainties: Dict[str, float] = {}
        #: par metadata (PSR, EPHEM, CLK, UNITS, TZRSITE, ...)
        self.meta: Dict[str, str] = {}
        #: {name: Param} when built from a par file (models.builder)
        self.params: Dict[str, object] = {}

    def component(self, name) -> Component:
        for c in self.components:
            if type(c).__name__ == name:
                return c
        raise KeyError(name)

    @property
    def delay_components(self):
        return [c for c in self.components if isinstance(c, DelayComponent)]

    @property
    def phase_components(self):
        return [c for c in self.components if isinstance(c, PhaseComponent)]

    @property
    def noise_components(self):
        from pint_tpu_torch.models.noise import NoiseComponent

        return [c for c in self.components if isinstance(c, NoiseComponent)]

    @property
    def has_correlated_errors(self) -> bool:
        return any(c.introduces_correlated_errors
                   for c in self.noise_components)

    @property
    def free_noise_params(self) -> List[str]:
        owned = {p for c in self.noise_components for p in c.params}
        return [p for p in self.free_params if p in owned]

    @property
    def free_timing_params(self) -> List[str]:
        noise = set(self.free_noise_params)
        return [p for p in self.free_params if p not in noise]

    def has_component(self, name) -> bool:
        return any(type(c).__name__ == name for c in self.components)

    def prepare(self, toas, tzr=None, device=None) -> "PreparedModel":
        """Bind to ``toas`` (and the one-row TZR table ``tzr``, or None
        for no absolute-phase reference) on ``device`` (CUDA unless
        given).  ``toas`` may be a :class:`~pint_tpu_torch.toa.TOAs`
        from ingest: with ``tzr`` None its TZR TOA is then built from
        the model's TZRMJD/TZRSITE/TZRFRQ, as the JAX package does."""
        toas, tzr = self.tables(toas, tzr)
        return PreparedModel(self, toas, tzr, resolve_device(device))

    def tables(self, toas, tzr=None):
        """(TOATable, TZR TOATable or None) for ``toas`` and ``tzr``:
        ingest TOAs become tables, and their TZR TOA comes from the
        AbsPhase component when ``tzr`` is None."""
        from pint_tpu_torch.toa import TOAs

        if isinstance(toas, TOAs):
            if tzr is None and self.has_component("AbsPhase"):
                tzr = self.component("AbsPhase").make_tzr_toas(self, toas)
            toas = toas.to_table()
        if isinstance(tzr, TOAs):
            tzr = tzr.to_table()
        return toas, tzr


def _ctx_patch_rows(old_ctx, mini_ctx, n0, n1, n_rows):
    """A component's ctx after an append, from the mini dataset's ctx
    (pint_tpu timing_model.py:483): per-row tensors (leading axis
    ``n_rows``, or axis 1 of a (k, n_rows) mask stack) take rows
    ``[n0, n1)`` from the mini's leading rows, on the device; every
    other entry (scalars, static depths) must equal the mini's.  None on
    any disagreement, and the caller runs the component's prepare
    instead.  Rows past ``n1`` keep the old pad values (weight
    ~1e-44)."""
    dn = n1 - n0
    if dn <= 0 or set(old_ctx) != set(mini_ctx):
        return None
    out = {}
    for k, v_old in old_ctx.items():
        v_mini = mini_ctx[k]
        if isinstance(v_old, torch.Tensor) and v_old.dim() >= 1 \
                and v_old.shape[0] == n_rows:
            if not isinstance(v_mini, torch.Tensor) \
                    or v_mini.dim() != v_old.dim() \
                    or v_mini.shape[0] < dn \
                    or v_mini.shape[1:] != v_old.shape[1:]:
                return None
            a = v_old.clone()
            a[n0:n1] = v_mini[:dn].to(v_old.dtype)
            out[k] = a
            continue
        if isinstance(v_old, torch.Tensor) and v_old.dim() == 2 \
                and v_old.shape[1] == n_rows:
            if not isinstance(v_mini, torch.Tensor) or v_mini.dim() != 2 \
                    or v_mini.shape[0] != v_old.shape[0] \
                    or v_mini.shape[1] < dn:
                return None
            a = v_old.clone()
            a[:, n0:n1] = v_mini[:, :dn].to(v_old.dtype)
            out[k] = a
            continue
        if isinstance(v_old, torch.Tensor) or isinstance(v_mini,
                                                         torch.Tensor):
            if not (isinstance(v_old, torch.Tensor)
                    and isinstance(v_mini, torch.Tensor)
                    and v_old.shape == v_mini.shape
                    and torch.equal(v_old, v_mini.to(v_old.device))):
                return None
        elif not v_old == v_mini:
            return None
        out[k] = v_old
    return out


class PreparedModel:
    """Model bound to a dataset: ctx built once, pure functions of
    values."""

    def __init__(self, model: TimingModel, toas, tzr, device):
        self.model = model
        self.toas = toas
        self.device = device
        self.batch = toas.to_batch(device)
        self.ctx = {type(c).__name__: c.prepare(toas, model, device)
                    for c in model.components}
        self.tzr_batch = None
        self.tzr_ctx = None
        if tzr is not None:
            self.tzr_batch = tzr.to_batch(device)
            self.tzr_ctx = {type(c).__name__: c.prepare(tzr, model, device)
                            for c in model.components}
        self._noise_basis_comps = [
            c for c in model.noise_components
            if c.n_basis(self.ctx[type(c).__name__]) > 0]
        self._su = None

    # -- streaming appends ----------------------------------------------------
    def prepare_appended(self, toas, n0, mini_ctx=None):
        """This model bound to ``toas``, the dataset after an append
        that turned pad rows ``[n0, n1)`` into real rows (pint_tpu
        timing_model.py:615), with every prepare-time anchor kept.

        A component with ``prepare_streamed`` extends its own ctx (the
        red-noise comb, the ECORR epochs) or vetoes (None: the caller
        re-prepares in full); a correlated component without the hook
        vetoes.  The others take the mini dataset's rows
        (:func:`_ctx_patch_rows`, ``mini_ctx`` the mini prepare's ctx)
        or, failing that, run their prepare.  The TZR batch and ctx are
        carried over: the absolute-phase anchor never moves.  The
        structured noise basis takes the new rows on the device when the
        components and widths are unchanged.  Returns the new
        PreparedModel, or None on a veto."""
        n1 = toas.n_filled or toas.n_real or len(toas)
        table = toas.to_table()
        n_rows = len(table)
        model = self.model
        ctx = {}
        for c in model.components:
            name = type(c).__name__
            old_ctx = self.ctx[name]
            hook = getattr(c, "prepare_streamed", None)
            if hook is not None:
                got = hook(table, model, old_ctx, n0, n1, self.device)
                if got is None:
                    return None
            elif getattr(c, "introduces_correlated_errors", False):
                return None
            else:
                got = None
                if mini_ctx is not None and name in mini_ctx:
                    got = _ctx_patch_rows(old_ctx, mini_ctx[name], n0, n1,
                                          n_rows)
                if got is None:
                    got = c.prepare(table, model, self.device)
            ctx[name] = got
        new = object.__new__(PreparedModel)
        new.model = model
        new.toas = table
        new.device = self.device
        new.batch = table.to_batch(self.device)
        new.ctx = ctx
        new.tzr_batch = self.tzr_batch
        new.tzr_ctx = self.tzr_ctx
        new._noise_basis_comps = [
            c for c in model.noise_components
            if c.n_basis(ctx[type(c).__name__]) > 0]
        new._su = None
        widths = [c.n_basis(ctx[type(c).__name__])
                  for c in new._noise_basis_comps]
        if (self._su is not None and n1 > n0
                and new._noise_basis_comps == self._noise_basis_comps
                and widths == [c.n_basis(self.ctx[type(c).__name__])
                               for c in self._noise_basis_comps]
                and n_rows == self._su.seg.shape[0]):
            new._su = self._su_rows_patched(new, n0, n1)
        return new

    def _su_rows_patched(self, new, n0, n1):
        """The structured basis of ``new`` from this one's: the dense
        blocks take rows ``[n0, n1)`` of ``new``'s component bases on the
        device; the epochs are ``new``'s ECORR ctx (the streaming hook
        certified them unchanged)."""
        from pint_tpu_torch.linalg import StructuredU

        pre, post = self._su.pre.clone(), self._su.post.clone()
        side, col = "pre", 0
        seg, perm, offsets = self._su.seg, self._su.perm, self._su.offsets
        for c in new._noise_basis_comps:
            cctx = new.ctx[type(c).__name__]
            if c.category == "ecorr_noise":
                seg, perm, offsets = cctx["seg"], cctx["perm"], \
                    cctx["offsets"]
                side, col = "post", 0
                continue
            k = c.n_basis(cctx)
            dst = pre if side == "pre" else post
            dst[n0:n1, col:col + k] = cctx["basis"][n0:n1]
            col += k
        return StructuredU(pre=pre, seg=seg, perm=perm, offsets=offsets,
                           post=post)

    def structured_basis(self):
        """The extended noise basis as a StructuredU, built once: dense
        blocks on either side of the (at most one) ECORR component's
        epochs, the mean-offset column of ones appended."""
        if self._su is not None:
            return self._su
        from pint_tpu_torch.linalg import structured_from_blocks

        n = len(self.toas)
        ecorrs = [c for c in self._noise_basis_comps
                  if c.category == "ecorr_noise"]
        if len(ecorrs) > 1:
            raise NotImplementedError(
                "more than one ECORR component: the dense-basis fallback "
                "is not ported (ROADMAP queue 1 item 3)")
        pre, post = [], []
        seg, k_e = np.zeros(n, dtype=np.int64), 0
        side = pre
        for c in self._noise_basis_comps:
            ctx = self.ctx[type(c).__name__]
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

        self._su = structured_from_blocks(cat(pre), seg, k_e, cat(post),
                                          self.device)
        return self._su

    # -- values ---------------------------------------------------------------
    def values_dict(self, values=None):
        """{name: 0-d float64 tensor on the device}."""
        v = self.model.values if values is None else values
        return {k: torch.tensor(float(x), dtype=torch.float64,
                                device=self.device) for k, x in v.items()}

    # -- noise interface ------------------------------------------------------
    def scaled_sigma_fn(self, values, batch=None, ctx=None):
        """Per-TOA uncertainty [s] after white-noise scaling."""
        batch = self.batch if batch is None else batch
        ctx = self.ctx if ctx is None else ctx
        sigma = batch.error_s
        for c in self.model.noise_components:
            sigma = c.scaled_sigma(values, batch, ctx[type(c).__name__],
                                   sigma)
        return sigma

    def noise_weights_fn(self, values, ctx=None):
        """Concatenated basis weights phi, in basis-column order."""
        ctx = self.ctx if ctx is None else ctx
        parts = [c.weights(values, ctx[type(c).__name__])
                 for c in self._noise_basis_comps]
        if not parts:
            return torch.zeros(0, dtype=torch.float64, device=self.device)
        return torch.cat(parts)

    def noise_dimensions(self):
        """{component_name: (start, length)} in the stacked basis."""
        out = {}
        start = 0
        for c in self._noise_basis_comps:
            nb = c.n_basis(self.ctx[type(c).__name__])
            out[type(c).__name__] = (start, nb)
            start += nb
        return out

    # -- the pure folds -------------------------------------------------------
    def _delay_raw(self, values, batch, ctx_map, frozen=None):
        """Sequential delay fold; ``frozen`` {component: (N,) delay}
        enters as data at its chain position."""
        total = torch.zeros(batch.ticks.shape, dtype=torch.float64,
                            device=batch.ticks.device)
        for c in self.model.delay_components:
            name = type(c).__name__
            if frozen is not None and name in frozen:
                total = total + frozen[name]
                continue
            total = total + c.delay(values, batch, ctx_map[name], total)
        return total

    def _phase_sum_given_delay(self, values, batch, ctx_map, delay):
        """The phase-component fold at an explicit total delay."""
        n = torch.zeros(batch.ticks.shape, dtype=torch.int64,
                        device=batch.ticks.device)
        frac = torch.zeros(batch.ticks.shape, dtype=torch.float64,
                           device=batch.ticks.device)
        for c in self.model.phase_components:
            ph = c.phase(values, batch, ctx_map[type(c).__name__], delay)
            if isinstance(ph, tuple):
                n = n + ph[0]
                frac = frac + ph[1]
            else:
                frac = frac + ph
        return n, frac

    def _phase_sum(self, values, batch, ctx_map, frozen=None):
        delay = self._delay_raw(values, batch, ctx_map, frozen=frozen)
        return self._phase_sum_given_delay(values, batch, ctx_map, delay)

    def _phase_raw_at(self, values, batch, ctx, tzr_batch, tzr_ctx,
                      frozen=None, tzr_frozen=None):
        """TZR-referenced (n, frac)."""
        n, frac = self._phase_sum(values, batch, ctx, frozen=frozen)
        if tzr_batch is not None:
            tn, tfrac = self._phase_sum(values, tzr_batch, tzr_ctx,
                                        frozen=tzr_frozen)
            n = n - tn[0]
            frac = frac - tfrac[0]
        return fp.renorm_phase(n, frac)

    def phase(self, values=None):
        """(int64 turns, f64 frac) at the dataset, TZR-referenced."""
        return self._phase_raw_at(self.values_dict(values), self.batch,
                                  self.ctx, self.tzr_batch, self.tzr_ctx)

    def delay(self, values=None):
        return self._delay_raw(self.values_dict(values), self.batch,
                               self.ctx)

    # -- hybrid design / frozen-delay partition -------------------------------
    def frozen_delay_split(self, free_names):
        """Delay components whose delays are constants of the fit: own no
        free parameter, read no free foreign one, and either ignore the
        accumulated delay or sit in the all-frozen chain prefix."""
        free = set(free_names)
        frozen = []
        seen_active = False
        for c in self.model.delay_components:
            active = any(p in free for p in c.params) or any(
                n in free for n in c.reads_params)
            if not active and (not c.reads_delay_accum or not seen_active):
                frozen.append(type(c).__name__)
            else:
                seen_active = True
        return tuple(frozen)

    def frozen_delay_leaves(self, frozen_names, values=None):
        """The frozen components' delay arrays (data, TZR) computed once,
        outside any transform."""
        if not frozen_names:
            return None, None
        want = set(frozen_names)
        v = self.values_dict(values)

        def fold(batch, ctx_map):
            out = {}
            total = torch.zeros(batch.ticks.shape, dtype=torch.float64,
                                device=self.device)
            for c in self.model.delay_components:
                name = type(c).__name__
                if name not in want:
                    continue
                d = c.delay(v, batch, ctx_map[name], total)
                out[name] = d
                total = total + d
            return out

        with torch.no_grad():
            data = fold(self.batch, self.ctx)
            tzr = (fold(self.tzr_batch, self.tzr_ctx)
                   if self.tzr_batch is not None else None)
        return data, tzr

    def frozen_param_values(self, frozen_names):
        """{param: value} over the frozen components and their foreign
        reads — the fingerprint that detects stale frozen leaves."""
        out = {}
        for c in self.model.delay_components:
            if type(c).__name__ in frozen_names:
                names = list(c.params) + [n for n in c.reads_params
                                          if n in self.model.values]
                for name in names:
                    out[name] = float(self.model.values.get(name, np.nan))
        return out

    def kepler_ecc_reach(self, values=None):
        """Largest |eccentricity| the binary chain can see at
        ``values``; -inf without a Kepler binary."""
        v = self.model.values if values is None else values
        reach = float("-inf")
        for c in self.model.delay_components:
            f = getattr(c, "ecc_reach", None)
            if f is not None:
                reach = max(reach, f(v, self.toas.ticks))
        return reach

    def ensure_kepler_depth(self, ecc_max):
        """Raise every binary ctx's static Newton depth to cover
        ``ecc_max`` (monotone).  True when any ctx changed."""
        from pint_tpu_torch.models.binary.kepler import newton_iters_for

        need = newton_iters_for(ecc_max)
        changed = False
        for ctx_map in (self.ctx, self.tzr_ctx):
            if not ctx_map:
                continue
            for sub in ctx_map.values():
                if sub.get("kepler_iters", need) < need:
                    sub["kepler_iters"] = need
                    changed = True
        return changed

    def design_partition(self, free_names, frozen=()):
        """Split free timing parameters into (linear, nonlinear), free
        order kept.  Linear iff every owner lists it in linear_params()
        and, for delay owners, no in-trace accum-reading delay component
        follows it, and no in-trace component reads it as a foreign
        parameter."""
        frozen = set(frozen)
        delay_comps = self.model.delay_components
        unsafe_after = [False] * len(delay_comps)
        flag = False
        for i in range(len(delay_comps) - 1, -1, -1):
            unsafe_after[i] = flag
            c = delay_comps[i]
            if c.reads_delay_accum and type(c).__name__ not in frozen:
                flag = True
        delay_pos = {id(c): i for i, c in enumerate(delay_comps)}
        read_elsewhere = set()
        for c in self.model.components:
            if type(c).__name__ not in frozen:
                read_elsewhere.update(c.reads_params)
        linear, nonlinear = [], []
        for name in free_names:
            owners = [c for c in self.model.components if c.has_param(name)]
            ok = bool(owners) and name not in read_elsewhere
            for c in owners:
                if name not in set(c.linear_params()):
                    ok = False
                    break
                if isinstance(c, DelayComponent) \
                        and unsafe_after[delay_pos[id(c)]]:
                    ok = False
                    break
            (linear if ok else nonlinear).append(name)
        return tuple(linear), tuple(nonlinear)

    def linear_phase_columns(self, values, batch, ctx_map, names,
                             frozen=None):
        """(N, L) d phase / d name [turns per unit] for phase-linear
        ``names``: one delay fold collecting each delay owner's closed
        form, one jvp through the phase stage for the shared d phase /
        d delay multiplier, and the phase owners' columns."""
        n_toa = batch.ticks.shape[0]
        want = list(names)
        delay_cols = {}
        phase_cols = {}

        def add(store, nm, col):
            prev = store.get(nm)
            store[nm] = col if prev is None else prev + col

        delay = torch.zeros(n_toa, dtype=torch.float64,
                            device=batch.ticks.device)
        for c in self.model.delay_components:
            cname = type(c).__name__
            ctx = ctx_map[cname]
            for nm in want:
                if c.has_param(nm):
                    add(delay_cols, nm,
                        c.d_delay_d_param(values, batch, ctx, delay, nm))
            if frozen is not None and cname in frozen:
                d = frozen[cname]
            else:
                d = c.delay(values, batch, ctx, delay)
            delay = delay + d

        if delay_cols:
            def frac_of(dly):
                return self._phase_sum_given_delay(values, batch, ctx_map,
                                                   dly)[1]

            _, dphase_ddelay = torch.func.jvp(
                frac_of, (delay,), (torch.ones_like(delay),))

        for c in self.model.phase_components:
            ctx = ctx_map[type(c).__name__]
            for nm in want:
                if c.has_param(nm):
                    add(phase_cols, nm,
                        c.d_phase_d_param(values, batch, ctx, delay, nm))

        cols = []
        for nm in want:
            col = phase_cols.get(nm)
            dcol = delay_cols.get(nm)
            if dcol is not None:
                dcol = dphase_ddelay * dcol
                col = dcol if col is None else col + dcol
            if col is None:
                col = torch.zeros(n_toa, dtype=torch.float64,
                                  device=batch.ticks.device)
            cols.append(col)
        return torch.stack(cols, dim=1)
