"""Gradient-based GWB posterior sampling (pint_tpu gw/hmc.py).

:class:`GWBPosterior` maps ``theta = (gwb log10_A, gwb gamma,
per-pulsar TNREDAMP / TNREDGAM)`` to the log posterior of the stacked
array, with the gradient flowing through the kron-structured Woodbury
of :mod:`pint_tpu_torch.linalg`: the per-pulsar capacity stage (kernel
K5 forward, K5b backward on CUDA) and the GW sector's LU (PyTorch's
``lu_factor_ex`` / ``lu_solve`` and their autograd).  Every chain is a
row of one batch; the per-pulsar grams (kernel K3, built once) are
shared by every chain and draw, since no sampled parameter touches
sigma.

:func:`run_nuts` is the reference's NUTS-class sampler in its
static-trajectory form: jittered-length leapfrog trajectories that run
all ``num_leapfrog`` steps under a per-chain ``active`` mask, endpoint
Metropolis acceptance, dual-averaging step size during warmup, a
diagonal metric from the per-parameter scales.  The elementwise work of
a transition is kernel K6 (``csrc/nuts_step.cu``): one launch per gap
between gradient calls, ``num_leapfrog + 1`` a draw.  The run is cut
into fixed-count chunks of :func:`pint_tpu_torch.iterate.iterate_fixed`;
nothing inside a chunk reads the device, and its records are copied to
the host once per chunk.  State buffers are updated in place.

Random numbers come from a ``torch.Generator`` on the posterior's
device, per draw in this order: the standard-normal momenta (C, ndim),
the trajectory lengths in [1, num_leapfrog] (C,), the acceptance
uniforms (C,).  JAX's threefry streams cannot be reproduced, so the
tests inject the reference's draws (``draws=``).

Not ported (ROADMAP): ``checkpoint`` and resume, ``mesh`` over chains,
sampled parameters that change sigma (an in-trace gram), the
``iter_trace`` telemetry records, and the dense (``kron=False``) path.
"""

from __future__ import annotations

import ctypes
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from pint_tpu_torch._cuda import CudaKernel
from pint_tpu_torch.fitter import FitDivergedError
from pint_tpu_torch.gw.common import CommonProcess, red_noise_layout
from pint_tpu_torch.iterate import iterate_fixed
from pint_tpu_torch.linalg import KronPhi, kron_chi2_logdet_pre
from pint_tpu_torch.models.noise import gwb_phi, powerlaw

__all__ = ["GWBPosterior", "run_nuts", "NUTSResult", "DEFAULT_BOUNDS",
           "DEFAULT_SCALES"]

#: prior bounds per parameter name (uniform prior; pint_tpu
#: gw/hmc.py:72)
DEFAULT_BOUNDS = {
    "gwb_log10_A": (-18.0, -11.0),
    "gwb_gamma": (0.0, 7.0),
    "TNREDAMP": (-20.0, -10.0),
    "TNREDGAM": (0.0, 7.0),
}
_FALLBACK_BOUNDS = (-30.0, 30.0)

#: diagonal-metric scales per parameter name (the mass matrix is
#: diag(1/scale^2); pint_tpu gw/hmc.py:84)
DEFAULT_SCALES = {
    "gwb_log10_A": 0.3,
    "gwb_gamma": 0.4,
    "TNREDAMP": 0.4,
    "TNREDGAM": 0.5,
}
_FALLBACK_SCALE = 0.2

# dual-averaging constants (Hoffman & Gelman 2014, algorithm 5;
# pint_tpu gw/hmc.py:350)
_DA_GAMMA = 0.05
_DA_T0 = 10.0
_DA_KAPPA = 0.75
#: energy-error threshold marking a transition divergent
_DIVERGENCE_DH = 1000.0

#: per-pulsar names the port samples: PLRedNoise's power law
SAMPLEABLE = ("TNREDAMP", "TNREDGAM")

#: kernel K6 (replaces the elementwise transition of pint_tpu
#: gw/hmc.py:357 _chunk_body, :365-421)
K6 = CudaKernel(
    "nuts_step", "nuts_step.cu", "nuts_step_launch",
    [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int64] * 3
    + [ctypes.c_int] * 2 + [ctypes.c_double] * 6)


def _probe_changes(fn, values, name, delta):
    """Does perturbing ``values[name]`` by ``delta`` change ``fn(values)``
    (pint_tpu gw/hmc.py:94)?"""
    base = fn(values).cpu().numpy()
    pert = dict(values)
    pert[name] = float(values[name]) + delta
    return not np.allclose(base, fn(pert).cpu().numpy(), rtol=0.0,
                           atol=0.0, equal_nan=True)


class GWBPosterior:
    """The differentiable stacked-array GWB posterior.

    theta layout: ``[gwb_log10_A, gwb_gamma] + [one entry per (pulsar,
    name) in sample order]``, a pulsar contributing the names of
    ``sample`` its model carries.  ``crn`` is a kron
    :class:`~pint_tpu_torch.gw.common.CommonProcess` built from pairs
    (its per-pulsar Residuals give the noise weights); the posterior
    runs on ``crn.device``.

    Only PLRedNoise's TNREDAMP and TNREDGAM are sampled: a name that
    changes sigma, or any other name, raises ``NotImplementedError``."""

    def __init__(self, crn: CommonProcess, sample=SAMPLEABLE, bounds=None,
                 scales=None):
        if crn.resids is None:
            raise ValueError(
                "GWBPosterior needs a CommonProcess built from pairs "
                "(resids attached); the _prebuilt path carries no prepared "
                "models")
        self.crn = crn
        self.device = crn.device
        self.param_names = ["gwb_log10_A", "gwb_gamma"]
        self.noise_params = []  # (pulsar index, name)
        for k, resid in enumerate(crn.resids):
            prep = resid.prepared
            vals = {n: float(v) for n, v in resid.model.values.items()}
            for name in sample:
                if name not in vals:
                    continue
                if _probe_changes(
                        lambda v: prep.scaled_sigma_fn(prep.values_dict(v)),
                        vals, name, 1e-3):
                    raise NotImplementedError(
                        f"{crn.names[k]}:{name} changes sigma; sampling it "
                        "needs a gram built in the gradient (not ported)")
                red = [c for c in resid.model.noise_components
                       if type(c).__name__ == "PLRedNoise"]
                if name not in SAMPLEABLE or not red or red[0].use_rn:
                    raise NotImplementedError(
                        f"{crn.names[k]}:{name}: only PLRedNoise's "
                        f"{SAMPLEABLE} are sampled")
                self.noise_params.append((k, name))
                self.param_names.append(f"{crn.names[k]}:{name}")
        self.ndim = len(self.param_names)
        b = dict(DEFAULT_BOUNDS)
        b.update(bounds or {})
        s = dict(DEFAULT_SCALES)
        s.update(scales or {})

        def look(table, full_name, fallback):
            short = full_name.split(":")[-1]
            return table.get(full_name, table.get(short, fallback))

        self.bounds = np.asarray(
            [look(b, n, _FALLBACK_BOUNDS) for n in self.param_names],
            dtype=np.float64)
        self.scales = np.asarray(
            [look(s, n, _FALLBACK_SCALE) for n in self.param_names],
            dtype=np.float64)
        dev = self.device
        kd = crn.kron_data
        self.gram = kd.gram
        self.phi0 = kd.phi_noise
        self.orf = kd.orf
        self._lo = torch.as_tensor(self.bounds[:, 0], device=dev)
        self._hi = torch.as_tensor(self.bounds[:, 1], device=dev)
        self._ln2pi_term = 0.5 * crn.n_toa_total * math.log(2.0 * math.pi)
        # where each pulsar's (TNREDAMP, TNREDGAM) come from: a theta
        # index, or the model's value
        p = crn.n_pulsars
        self._rn_mask, self._rn_freqs, self._rn_df = red_noise_layout(
            [r.prepared for r in crn.resids], self.phi0.shape[-1], dev)
        idx = {n: np.full(p, -1, np.int64) for n in SAMPLEABLE}
        base = {n: np.zeros(p) for n in SAMPLEABLE}
        for k, resid in enumerate(crn.resids):
            for n in SAMPLEABLE:
                base[n][k] = float(resid.model.values.get(n, 0.0))
        for j, (k, name) in enumerate(self.noise_params):
            idx[name][k] = 2 + j
        self._rn_idx = {n: torch.as_tensor(idx[n], device=dev)
                        for n in SAMPLEABLE}
        self._rn_base = {n: torch.as_tensor(base[n], device=dev)
                         for n in SAMPLEABLE}

    # -- theta -> model ingredients ------------------------------------------

    def values_at(self, theta, k):
        """Pulsar k's values (host floats) with its sampled parameters
        set from one theta row."""
        theta = np.asarray(theta, np.float64)
        values = {n: float(v) for n, v in
                  self.crn.resids[k].model.values.items()}
        for j, (pi, name) in enumerate(self.noise_params):
            if pi == k:
                values[name] = float(theta[2 + j])
        return values

    def phi_noise_at(self, th):
        """(..., P, nb) padded noise weights at theta (..., ndim): every
        pulsar's red-noise block from its (TNREDAMP, TNREDGAM), the rest
        of the build's row unchanged, all pulsars and chains at once."""
        def pick(name):
            i = self._rn_idx[name]
            return torch.where(i >= 0, th[..., i.clamp(min=0)],
                               self._rn_base[name])
        amp, gam = pick("TNREDAMP"), pick("TNREDGAM")
        pl = powerlaw(self._rn_freqs, 10.0 ** amp[..., None],
                      gam[..., None]) * self._rn_df[:, None]
        return torch.where(self._rn_mask, pl, self.phi0)

    # -- the log posterior ----------------------------------------------------

    def lnprob(self, theta):
        """Log posterior at theta (..., ndim), uniform prior inside
        ``bounds``: -inf outside, with the likelihood evaluated at the
        clipped point (pint_tpu gw/hmc.py:239-268)."""
        inside = torch.all((theta >= self._lo) & (theta <= self._hi),
                           dim=-1)
        th = torch.clamp(theta, self._lo, self._hi)
        phi_gw = gwb_phi(self.crn.freqs, 10.0 ** th[..., 0:1],
                         th[..., 1:2], self.crn.df)
        kp = KronPhi(orf=self.orf, phi_gw=phi_gw,
                     phi_noise=self.phi_noise_at(th))
        chi2, logdet = kron_chi2_logdet_pre(self.gram, kp)
        lnl = -0.5 * (chi2 + logdet) - self._ln2pi_term
        return torch.where(inside, lnl, torch.full_like(lnl, -math.inf))

    def value_and_grad(self, theta):
        """(lnprob (C,), d lnprob / d theta (C, ndim)) at theta (C,
        ndim), by ``torch.autograd.grad``; chains are independent."""
        with torch.enable_grad():
            th = theta.detach().clone().requires_grad_(True)
            lnp = self.lnprob(th)
            (g,) = torch.autograd.grad(lnp.sum(), th)
        return lnp.detach(), g

    def center(self):
        """Chain center: -14.5 and 13/3 for the GWB, each model's value
        for the sampled parameters, clipped inside the bounds."""
        c = np.empty(self.ndim)
        c[0] = -14.5
        c[1] = 13.0 / 3.0
        for j, (k, name) in enumerate(self.noise_params):
            c[2 + j] = float(self.crn.resids[k].model.values[name])
        return np.clip(c, self.bounds[:, 0] + 1e-6,
                       self.bounds[:, 1] - 1e-6)

    def initial_chains(self, n_chains, seed=0, center=None, ball=0.1):
        """(n_chains, ndim) starts: a scaled Gaussian ball around
        :meth:`center` from numpy's ``default_rng(seed)`` (the
        reference's draws bit for bit), clipped inside the prior."""
        rng = np.random.default_rng(seed)
        c = self.center() if center is None else np.asarray(center)
        x0 = c[None, :] + ball * self.scales[None, :] * \
            rng.standard_normal((int(n_chains), self.ndim))
        return np.clip(x0, self.bounds[None, :, 0] + 1e-9,
                       self.bounds[None, :, 1] - 1e-9)


class NUTSResult(NamedTuple):
    """What :func:`run_nuts` returns (pint_tpu gw/hmc.py:327), plus the
    accept decisions and the wall time of each chunk."""

    samples: np.ndarray         # (num_samples, n_chains, ndim)
    lnprob: np.ndarray          # (num_samples, n_chains)
    accept_rate: float          # post-warmup mean acceptance probability
    step_size: np.ndarray       # (n_chains,) step size of the last draw
    divergences: int            # post-warmup divergent transitions
    warmup_samples: np.ndarray  # (num_warmup, n_chains, ndim)
    accepted: Optional[np.ndarray] = None  # (warmup + samples, n_chains)
    chunk_seconds: Optional[list] = None   # host wall time per chunk

    def flat(self):
        """(num_samples * n_chains, ndim) flattened posterior."""
        s = np.asarray(self.samples)
        return s.reshape(-1, s.shape[-1])

    def max_posterior(self):
        """(theta, lnp) at the best sampled point."""
        lnp = np.asarray(self.lnprob)
        i, j = np.unravel_index(np.argmax(lnp), lnp.shape)
        return np.asarray(self.samples[i, j]), float(lnp[i, j])


# --------------------------------------------------------------------------
# the transition's elementwise stages (kernel K6 and its plain versions)
# --------------------------------------------------------------------------

class NutsState:
    """The sampler's device state, updated in place: chain state (x, g,
    lnp), trajectory (x1, p1, g1, lnp1), proposal (xn, ph) and the
    gradient taken there (gn, lnp_n), this draw's random numbers (z,
    n_steps, u), step-size adaptation, and the draw's outputs."""

    _F64 = ("x", "g", "lnp", "x1", "p1", "g1", "lnp1", "xn", "ph", "gn",
            "lnp_n", "z", "u", "inv_mass", "eps", "log_eps", "hbar",
            "log_eps_bar", "mu", "acc", "eps_used")
    #: the tensors K6 reads and writes, in its pointer order
    _K6 = ("x", "g", "lnp", "x1", "p1", "g1", "lnp1", "xn", "ph", "gn",
           "lnp_n", "z", "n_steps", "u", "inv_mass", "eps", "log_eps",
           "hbar", "log_eps_bar", "mu", "acc", "divergent", "accepted",
           "eps_used")

    def __init__(self, x, g, lnp, inv_mass, step_size0):
        c, nd = x.shape
        dev = x.device
        f64 = dict(dtype=torch.float64, device=dev)
        self.x, self.g, self.lnp = x.contiguous(), g.contiguous(), \
            lnp.contiguous()
        self.inv_mass = inv_mass.contiguous()
        for name in ("x1", "p1", "g1", "xn", "ph", "gn", "z"):
            setattr(self, name, torch.zeros((c, nd), **f64))
        for name in ("lnp1", "lnp_n", "u", "hbar", "acc", "eps_used"):
            setattr(self, name, torch.zeros(c, **f64))
        self.lnp1.fill_(-math.inf)
        self.log_eps = torch.full((c,), math.log(step_size0), **f64)
        self.log_eps_bar = self.log_eps.clone()
        self.mu = torch.full((c,), math.log(10.0 * step_size0), **f64)
        self.eps = torch.exp(self.log_eps)
        self.n_steps = torch.ones(c, dtype=torch.int64, device=dev)
        self.divergent = torch.zeros(c, dtype=torch.bool, device=dev)
        self.accepted = torch.zeros(c, dtype=torch.bool, device=dev)
        self.it = 0
        self._k6_ptrs = None  # K6's packed pointers, from its first launch

    def __setattr__(self, name, value):
        # a rebound tensor moves K6's pointers: repack at the next launch
        if name in self._K6:
            object.__setattr__(self, "_k6_ptrs", None)
        object.__setattr__(self, name, value)

    @property
    def n_chains(self):
        return self.x.shape[0]

    @property
    def ndim(self):
        return self.x.shape[1]

    def tensors(self):
        return [getattr(self, n) for n in self._F64] + [
            self.n_steps, self.divergent, self.accepted]


def _da_scalars(it):
    """The dual-averaging scalars of draw ``it`` (pint_tpu
    gw/hmc.py:408-413), on the host: (1 - 1/(t + t0), t + t0,
    sqrt(t) / gamma, t^-kappa, 1 - t^-kappa) at t = it + 1."""
    t = it + 1.0
    eta = t ** (-_DA_KAPPA)
    return (1.0 - 1.0 / (t + _DA_T0), t + _DA_T0,
            math.sqrt(t) / _DA_GAMMA, eta, 1.0 - eta)


def _k6_launch(st: NutsState, stage, step=0, adapting=False,
               adapting_next=False, target=0.0, it=0):
    """One K6 launch on the state's card.  The state is checked and its
    24 pointers packed at its first launch, and again only after one of
    its tensors is rebound (``NutsState.__setattr__``): the updates are
    in place, so the pointers do not move."""
    if st._k6_ptrs is None:
        ts = st.tensors()
        dev = st.x.device
        if dev.type != "cuda" or any(t.device != dev for t in ts):
            raise ValueError("nuts_step_cuda: the state must be on one CUDA "
                             "device")
        if not all(t.is_contiguous() for t in ts):
            raise ValueError("nuts_step_cuda: the state must be contiguous")
        if any(t.dtype != torch.float64 for t in ts[:-3]) \
                or st.n_steps.dtype != torch.int64:
            raise ValueError("nuts_step_cuda: float64 state, int64 n_steps")
        st._k6_ptrs = (ctypes.c_void_p * 24)(*(
            getattr(st, n).data_ptr() for n in NutsState._K6))
    c1, tt0, sq, eta, ometa = _da_scalars(it)
    K6.launch(st.x.device, int(stage), st._k6_ptrs, st.n_chains, st.ndim,
              int(step), int(bool(adapting)), int(bool(adapting_next)),
              float(target), c1, tt0, sq, eta, ometa)


def nuts_leap_pre_plain(st: NutsState, step):
    """pre(step) in torch ops: the half-kick and drift before gradient
    ``step``."""
    e = st.eps[:, None]
    if step == 0:
        x, g, p = st.x, st.g, st.z / torch.sqrt(st.inv_mass)
    else:
        x, g, p = st.x1, st.g1, st.p1
    h = p + (0.5 * e) * g
    st.ph.copy_(h)
    st.xn.copy_(x + (e * st.inv_mass) * h)


def nuts_leap_post_plain(st: NutsState, step):
    """post(step) in torch ops: the closing half-kick and the masked
    select after gradient ``step``."""
    active = step < st.n_steps
    a2 = active[:, None]
    pn = st.ph + (0.5 * st.eps[:, None]) * st.gn
    st.x1.copy_(torch.where(a2, st.xn, st.x1))
    st.p1.copy_(torch.where(a2, pn, st.p1))
    st.g1.copy_(torch.where(a2, st.gn, st.g1))
    st.lnp1.copy_(torch.where(active, st.lnp_n, st.lnp1))


def _kinetic(p, inv_mass):
    """sum_k (p_k p_k) inv_mass_k per chain, coordinates added in
    ascending order (K6's order)."""
    ke = torch.zeros(p.shape[0], dtype=p.dtype, device=p.device)
    for k in range(p.shape[1]):
        ke = ke + (p[:, k] * p[:, k]) * inv_mass[k]
    return ke


def nuts_draw_end_plain(st: NutsState, adapting, adapting_next, target,
                        it):
    """The draw's end in torch ops: energies, acceptance, divergence, the
    accept select, dual averaging and the next draw's step size."""
    c1, tt0, sq, eta, ometa = _da_scalars(it)
    p0 = st.z / torch.sqrt(st.inv_mass)
    h0 = -st.lnp + 0.5 * _kinetic(p0, st.inv_mass)
    h1 = -st.lnp1 + 0.5 * _kinetic(st.p1, st.inv_mass)
    dh = h0 - h1
    fin = torch.isfinite(dh)
    acc = torch.where(fin, torch.exp(torch.clamp(dh, max=0.0)),
                      torch.zeros_like(dh))
    div = torch.isnan(dh) | ((-dh > _DIVERGENCE_DH)
                             & torch.isfinite(st.lnp1))
    accept = torch.log(st.u) < dh
    st.x.copy_(torch.where(accept[:, None], st.x1, st.x))
    st.g.copy_(torch.where(accept[:, None], st.g1, st.g))
    st.lnp.copy_(torch.where(accept, st.lnp1, st.lnp))
    if adapting:
        # a tensor divisor: PyTorch multiplies by the reciprocal of a
        # scalar one, which rounds differently from K6's division
        hb = c1 * st.hbar + (target - acc) / torch.full_like(acc, tt0)
        le = st.mu - sq * hb
        st.log_eps_bar.copy_(eta * le + ometa * st.log_eps_bar)
        st.hbar.copy_(hb)
        st.log_eps.copy_(le)
    st.acc.copy_(acc)
    st.divergent.copy_(div)
    st.accepted.copy_(accept)
    st.eps_used.copy_(st.eps)
    st.eps.copy_(torch.exp(st.log_eps if adapting_next else st.log_eps_bar))


def _k6_or_plain(st: NutsState, name):
    if st.x.device.type == "cuda":
        return True
    if st.x.device.type != "cpu":
        raise ValueError(f"{name}: no version for {st.x.device}")
    return False


def nuts_draw_start(st: NutsState):
    """Before gradient 0: pre(0).  K6 on CUDA, the plain version on the
    CPU."""
    if _k6_or_plain(st, "nuts_draw_start"):
        _k6_launch(st, 0)
    else:
        nuts_leap_pre_plain(st, 0)


def nuts_leap_next(st: NutsState, step):
    """Between gradients ``step`` and ``step + 1``: post(step), then
    pre(step + 1).  One K6 launch on CUDA, the plain stages in turn on
    the CPU."""
    if _k6_or_plain(st, "nuts_leap_next"):
        _k6_launch(st, 1, step=step)
    else:
        nuts_leap_post_plain(st, step)
        nuts_leap_pre_plain(st, step + 1)


def nuts_draw_finish(st: NutsState, step, adapting, adapting_next, target,
                     it):
    """After the last gradient ``step``: post(step), then the draw's end
    (draw ``it``; dual averaging while ``adapting``, the next draw's step
    size as ``adapting_next``).  One K6 launch on CUDA, the plain stages
    in turn on the CPU."""
    if _k6_or_plain(st, "nuts_draw_finish"):
        _k6_launch(st, 2, step=step, adapting=adapting,
                   adapting_next=adapting_next, target=target, it=it)
    else:
        nuts_leap_post_plain(st, step)
        nuts_draw_end_plain(st, adapting, adapting_next, target, it)


def _draw_record(_prev, st: NutsState):
    """One draw's record (pint_tpu gw/hmc.py:441), copied off the
    in-place state."""
    return {"theta": st.x.clone(), "lnp": st.lnp.clone(),
            "accept": st.acc.clone(), "divergent": st.divergent.clone(),
            "accepted": st.accepted.clone(), "eps": st.eps_used.clone()}


def _injected(draws, n_draws, n_chains, nd, num_leapfrog, device):
    """The test-only ``draws=`` (z, n_steps, u) on the device, checked
    on the host."""
    z, n_steps, u = (np.asarray(d) for d in draws)
    if z.shape != (n_draws, n_chains, nd) or n_steps.shape != (
            n_draws, n_chains) or u.shape != (n_draws, n_chains):
        raise ValueError(f"run_nuts: draws must be (z ({n_draws}, "
                         f"{n_chains}, {nd}), n_steps and u ({n_draws}, "
                         f"{n_chains}))")
    if n_steps.min() < 1 or n_steps.max() > num_leapfrog:
        raise ValueError("run_nuts: n_steps outside [1, num_leapfrog]")
    return (torch.as_tensor(z, dtype=torch.float64, device=device),
            torch.as_tensor(n_steps, dtype=torch.int64, device=device),
            torch.as_tensor(u, dtype=torch.float64, device=device))


def run_nuts(posterior: GWBPosterior, *, num_warmup=300, num_samples=500,
             n_chains=4, seed=0, x0=None, num_leapfrog=12,
             target_accept=0.8, step_size0=0.02, chunk=None,
             generator=None, draws=None) -> NUTSResult:
    """Sample a :class:`GWBPosterior` (pint_tpu gw/hmc.py:454; module
    docstring for what the sampler is).  Runs on the posterior's device.

    generator: a ``torch.Generator`` on that device (default: one seeded
    with ``seed``).  draws: test-only ``(z, n_steps, u)`` host arrays of
    shapes (n_chunks * chunk, n_chains, ndim), (.., n_chains) and (..,
    n_chains) that replace the generator's numbers.  A run whose
    post-warmup positions are not all finite, or whose post-warmup
    lnprob is -inf everywhere, raises ``FitDivergedError``."""
    dev = posterior.device
    total = int(num_warmup) + int(num_samples)
    if chunk is None:
        chunk = min(64, total)
    chunk = max(1, int(chunk))
    n_chunks = -(-total // chunk)
    padded_total = n_chunks * chunk
    nd = posterior.ndim
    nw, ns = int(num_warmup), int(num_samples)
    n_leap = int(num_leapfrog)
    if x0 is None:
        x0 = posterior.initial_chains(n_chains, seed=seed)
    x0 = np.asarray(x0, dtype=np.float64)
    if x0.shape != (n_chains, nd):
        raise ValueError(f"run_nuts: x0 shape {x0.shape} != (n_chains, "
                         f"ndim) = ({n_chains}, {nd})")
    if draws is not None:
        inj = _injected(draws, padded_total, n_chains, nd, n_leap, dev)
    elif generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    inv_mass = torch.as_tensor(posterior.scales**2, device=dev)
    x = torch.as_tensor(x0, device=dev)
    lnp0, g0 = posterior.value_and_grad(x)
    st = NutsState(x, g0, lnp0, inv_mass, float(step_size0))
    target = float(target_accept)

    def body(st: NutsState):
        d = st.it
        if draws is not None:
            st.z.copy_(inj[0][d])
            st.n_steps.copy_(inj[1][d])
            st.u.copy_(inj[2][d])
        else:
            st.z.copy_(torch.randn((n_chains, nd), generator=generator,
                                   dtype=torch.float64, device=dev))
            st.n_steps.copy_(torch.randint(1, n_leap + 1, (n_chains,),
                                           generator=generator, device=dev))
            st.u.copy_(torch.rand(n_chains, generator=generator,
                                  dtype=torch.float64, device=dev))
        # n_leap + 1 K6 launches a draw, one per gap between gradients
        nuts_draw_start(st)
        for i in range(n_leap):
            lnp_n, gn = posterior.value_and_grad(st.xn)
            st.lnp_n.copy_(lnp_n)
            st.gn.copy_(gn)
            if i + 1 < n_leap:
                nuts_leap_next(st, i)
        nuts_draw_finish(st, n_leap - 1, d < nw, d + 1 < nw, target, d)
        st.it = d + 1
        return st

    recs, chunk_s = [], []
    for _ in range(n_chunks):
        t0 = time.perf_counter()
        st, rec = iterate_fixed(body, st, chunk, trace_of=_draw_record)
        recs.append({k: v.cpu().numpy() for k, v in rec.items()})
        chunk_s.append(time.perf_counter() - t0)

    def cat(key):
        return np.concatenate([r[key] for r in recs], axis=0)
    theta_all, lnp_all = cat("theta"), cat("lnp")
    acc_all, div_all, eps_all = cat("accept"), cat("divergent"), cat("eps")
    post = slice(nw, nw + ns)
    # the chain-health verdict (pint_tpu gw/hmc.py:642-657)
    pos_ok = bool(np.all(np.isfinite(theta_all[post])))
    lnp_ok = bool(np.any(np.isfinite(lnp_all[post])))
    if not (pos_ok and lnp_ok):
        raise FitDivergedError(
            f"gw.hmc.run_nuts: HMC chains diverged (positions finite "
            f"{pos_ok}, any finite lnp {lnp_ok})")
    return NUTSResult(
        samples=theta_all[post], lnprob=lnp_all[post],
        accept_rate=float(np.mean(acc_all[post])),
        step_size=np.asarray(eps_all[-1]),
        divergences=int(np.sum(div_all[post])),
        warmup_samples=theta_all[:nw],
        accepted=cat("accepted")[:total], chunk_seconds=chunk_s)
