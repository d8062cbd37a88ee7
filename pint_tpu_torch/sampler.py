"""Ensemble MCMC: Goodman-Weare stretch moves (pint_tpu sampler.py).

The affine-invariant stretch move (Goodman & Weare 2010, the algorithm
emcee implements) with the red-black split: each step moves the first
half of the walkers against the second, then the second half against
the updated first.  A half-move is one batched posterior call between
two parts of kernel K9 (``csrc/stretch_move.cu``):

1. propose: z = ((a - 1) u + 1)^2 / a and proposal = other[idx] + z
   (active - other[idx]) for every walker of the half;
2. lnp_prop = ``torch.func.vmap(lnpost)`` of the proposals;
3. accept: lnratio = (ndim - 1) log z + lnp_prop - lnp, accept = log
   u_acc < lnratio (a NaN rejects), the walker and its lnp replaced in
   place, the accept flags and the half's count written.

K9 is one launch per gap between posterior calls
(:func:`stretch_move` on the ensemble's :class:`StretchBuffers`), three
a step: propose half 0; accept half 0 and propose half 1 against it;
accept half 1.

The arithmetic is the reference's as XLA compiles it on the CPU: the
multiply-adds contracted to fused multiply-adds, (a - 1) u + 1,
other + z d and (ndim - 1) log z + lnp_prop, and the division by a a
multiplication by 1/a.  K9 calls ``fma()``; the plain versions compute
an exactly rounded fma from error-free transforms (:func:`fma_exact`),
so a chain that takes the same decisions holds the same bits.

The chain is a fixed-count loop (:func:`pint_tpu_torch.iterate.
iterate_fixed`): nothing inside it reads the device, its records stay on
the device and come to the host in one copy per call.  Random numbers
come from a ``torch.Generator`` on the device, per half-move in this
order: the uniforms of z (h,), the partner indices (h,), the acceptance
uniforms (h,).  JAX's threefry streams cannot be reproduced, so the
tests inject the reference's draws (``draws=``).

Not ported (ROADMAP): ``checkpoint=`` (the guard's checkpoint files,
queue 1 item 2) and ``mesh=`` (walkers sharded over cards, queue 1
item 14), which raise.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch._cuda import CudaKernel
from pint_tpu_torch import fitter as _fitter
from pint_tpu_torch.iterate import iterate_fixed

__all__ = ["run_mcmc", "EnsembleSampler", "integrated_autocorr_time",
           "AutocorrCache", "FitDivergedError", "K9"]

#: kernel K9 (replaces the elementwise work of pint_tpu sampler.py:207
#: _stretch_half, scanned by :224 run_mcmc)
K9 = CudaKernel(
    "stretch_move", "stretch_move.cu", "stretch_move_launch",
    [ctypes.c_int] * 2 + [ctypes.c_void_p] * 14 + [ctypes.c_int64] * 2
    + [ctypes.c_double] * 2)


class FitDivergedError(_fitter.FitDivergedError):
    """A chain that ended with a non-finite walker or with no finite
    log-posterior (pint_tpu guard.FitDivergedError, until the guard is
    ported).  ``last_good`` is the initial ensemble."""

    def __init__(self, msg, health=None, last_good=None):
        super().__init__(msg)
        self.health = health or {}
        self.last_good = last_good


# --------------------------------------------------------------------------
# autocorrelation (numpy, host)
# --------------------------------------------------------------------------

def integrated_autocorr_time(chain, c=5.0):
    """Per-parameter integrated autocorrelation time of a chain
    (nsteps, nwalkers, ndim), emcee's estimator: the walker-averaged
    autocorrelation function by FFT, with Sokal's adaptive window (the
    smallest M with M >= c tau(M))."""
    x = np.asarray(chain, np.float64)
    nsteps, nwalkers, ndim = x.shape
    taus = np.empty(ndim)
    for d in range(ndim):
        y = x[:, :, d] - x[:, :, d].mean(axis=0, keepdims=True)
        n2 = 1 << (2 * nsteps - 1).bit_length()
        f = np.fft.rfft(y, n=n2, axis=0)
        acf = np.fft.irfft(f * np.conjugate(f), n=n2, axis=0)[:nsteps]
        acf = acf.mean(axis=1)
        if acf[0] <= 0:
            taus[d] = np.inf
            continue
        rho = acf / acf[0]
        cumsum = 2.0 * np.cumsum(rho) - 1.0  # tau(M) = 1 + 2 sum_1^M rho
        window = np.arange(len(cumsum)) >= c * cumsum
        m = np.argmax(window) if window.any() else len(cumsum) - 1
        taus[d] = max(cumsum[m], 1e-12)
    return taus


class AutocorrCache:
    """Incremental windowed autocorrelation over a chain that grows by
    chunks (pint_tpu sampler.AutocorrCache).

    Keeps the raw lag-product sums S(l) = sum_t x_t x_{t+l} for l < L
    per walker and dimension and folds each chunk in with one FFT
    cross-correlation of (tail + chunk) against the chunk; the walker
    means enter algebraically from cached prefix, suffix and total
    sums, so the windowed acf is the estimator's.  When the window
    search needs lags past L, L doubles and the cache is rebuilt from
    the full chain (``rebuilds``); other chunks count in ``updates``."""

    def __init__(self, lag0=64):
        self.lag0 = max(4, int(lag0))
        self.n_steps = 0
        self._S = None        # (nw, ndim, L) raw lag-product sums
        self._total = None    # (nw, ndim) running sums
        self._head = None     # first <= L-1 samples (t, nw, ndim)
        self._tail = None     # last <= L-1 samples
        self.updates = 0
        self.rebuilds = 0

    @property
    def max_lag(self):
        return 0 if self._S is None else self._S.shape[2]

    def _delta_S(self, chunk):
        """Raw lag-product contributions of appending ``chunk``, by one
        padded-FFT cross-correlation of (tail ++ chunk) against it."""
        L = self.max_lag
        n = chunk.shape[0]
        tail = self._tail if self._tail is not None else chunk[:0]
        m0 = tail.shape[0]
        z = np.concatenate([tail, chunk], axis=0)
        # linear correlation for every shift in [-(L-1), m0]
        nfft = 1
        while nfft < max(z.shape[0] + n, 2 * L):
            nfft *= 2
        zf = np.fft.rfft(z, n=nfft, axis=0)
        cf = np.fft.rfft(chunk, n=nfft, axis=0)
        w = np.fft.irfft(zf * np.conjugate(cf), n=nfft, axis=0)
        # dS(l) = sum_j z[m0 - l + j] * chunk[j]  ==  w[(m0 - l) % nfft]
        idx = (m0 - np.arange(L)) % nfft
        return np.transpose(w[idx], (1, 2, 0))  # (nw, ndim, L)

    def update(self, chunk):
        """Fold one appended chunk (n, nwalkers, ndim) into the cache."""
        chunk = np.asarray(chunk, np.float64)
        if self._S is None:
            n, nw, nd = chunk.shape
            self._S = np.zeros((nw, nd, self.lag0))
            self._total = np.zeros((nw, nd))
            self._head = chunk[:0]
            self._tail = chunk[:0]
        self._S += self._delta_S(chunk)
        self._total += chunk.sum(axis=0)
        self.n_steps += chunk.shape[0]
        keep = self.max_lag - 1
        if self._head.shape[0] < keep:
            self._head = np.concatenate(
                [self._head, chunk], axis=0)[:keep]
        self._tail = np.concatenate(
            [self._tail, chunk], axis=0)[-keep:] if keep else chunk[:0]
        self.updates += 1

    def _rebuild(self, full, L):
        """From-scratch rebuild at a larger lag window."""
        full = np.asarray(full, np.float64)
        T, nw, nd = full.shape
        L = int(min(L, T))
        n2 = 1 << (2 * T - 1).bit_length()
        f = np.fft.rfft(full, n=n2, axis=0)
        acf_raw = np.fft.irfft(f * np.conjugate(f), n=n2, axis=0)[:L]
        self._S = np.transpose(acf_raw, (1, 2, 0))
        self._total = full.sum(axis=0)
        self.n_steps = T
        self._head = full[:L - 1]
        self._tail = full[-(L - 1):] if L > 1 else full[:0]
        self.rebuilds += 1

    def _windowed_tau(self, c):
        """Per-dim tau from the cached window, or None where the window
        search ran off the cached lag range."""
        T = self.n_steps
        Le = min(self.max_lag, T)
        m = self._total / T  # (nw, ndim)
        lags = np.arange(Le)
        pre = np.zeros((Le,) + m.shape)
        pre[1:] = np.cumsum(self._head[:Le - 1], axis=0)
        suf = np.zeros((Le,) + m.shape)
        if Le > 1:
            suf[1:] = np.cumsum(self._tail[::-1][:Le - 1], axis=0)
        g_head = self._total[None] - suf       # (Le, nw, ndim)
        g_tail = self._total[None] - pre
        acf_w = (np.transpose(self._S[:, :, :Le], (2, 0, 1))
                 - m[None] * (g_head + g_tail)
                 + (T - lags)[:, None, None] * m[None] ** 2)
        acf = acf_w.mean(axis=1)               # (Le, ndim)
        ndim = acf.shape[1]
        taus = np.empty(ndim)
        for d in range(ndim):
            if acf[0, d] <= 0:
                taus[d] = np.inf
                continue
            rho = acf[:, d] / acf[0, d]
            cumsum = 2.0 * np.cumsum(rho) - 1.0
            window = np.arange(Le) >= c * cumsum
            if window.any():
                taus[d] = max(cumsum[np.argmax(window)], 1e-12)
            elif Le >= T:
                # every lag is covered: the estimator's "no window"
                # answer, the full-length cumsum
                taus[d] = max(cumsum[-1], 1e-12)
            else:
                return None  # the window ran past the cache: grow
        return taus

    def tau(self, full_chain, c=5.0):
        """Integrated autocorrelation times, growing the lag window from
        ``full_chain`` only when the search needs it; equal to
        :func:`integrated_autocorr_time` to FFT roundoff."""
        while True:
            got = self._windowed_tau(c)
            if got is not None:
                return got
            self._rebuild(full_chain, max(2 * self.max_lag, 4))


# --------------------------------------------------------------------------
# the stretch move (kernel K9 and its plain versions)
# --------------------------------------------------------------------------

_SPLIT = 134217729.0  # 2^27 + 1, Veltkamp's splitter for float64


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    def split(x):
        c = _SPLIT * x
        hi = c - (c - x)
        return hi, x - hi
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma_exact(a, b, c):
    """a b + c rounded once (an IEEE fused multiply-add) from separately
    rounded float64 operations: the exact product and sum as
    error-free pairs, their low parts added with rounding to odd, then
    one rounding to nearest (Boldo & Melquiond 2008).  Exact for finite
    operands away from overflow and underflow; where a b + c is not
    finite it is that (an infinite c gives an infinite result, as a
    fused multiply-add does, and NaN stays NaN)."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    s, e = _two_sum(tl, ul)
    even = (s.view(torch.int64) & 1) == 0
    odd = torch.nextafter(s, torch.where(e > 0, math.inf, -math.inf))
    fused = th + torch.where((e != 0) & even, odd, s)
    naive = uh + c
    return torch.where(torch.isfinite(naive), fused, naive)


def stretch_propose_plain(active, other, u, idx, a):
    """The propose of K9 in torch ops: (proposal (h, ndim), z (h,)) from the
    uniforms ``u`` and partner indices ``idx`` (pint_tpu
    sampler.py:211-216)."""
    one = torch.ones_like(u)
    t = fma_exact(torch.full_like(u, a - 1.0), u, one)
    z = (t * t) * (1.0 / a)
    o = other[idx]
    return fma_exact(z[:, None], active - o, o), z


def stretch_accept_plain(active, lnp, proposal, z, lnp_prop, u_acc,
                         accepted, count):
    """The accept of K9 in torch ops (pint_tpu sampler.py:217-220): the
    decisions into ``accepted`` (h,) uint8 and their number into
    ``count`` (1,) int64; ``active`` and ``lnp`` take the accepted
    proposals in place."""
    nd = active.shape[1]
    lnratio = fma_exact(torch.full_like(z, nd - 1.0), torch.log(z),
                        lnp_prop) - lnp
    acc = torch.log(u_acc) < lnratio
    accepted.copy_(acc)
    count.copy_(torch.sum(acc, dtype=torch.int64).reshape(1))
    active.copy_(torch.where(acc[:, None], proposal, active))
    lnp.copy_(torch.where(acc, lnp_prop, lnp))


class StretchBuffers(NamedTuple):
    """The red-black ensemble of 2h walkers as K9 updates it in place:
    the walkers ``x`` (2h, ndim) and their ``lnp`` (2h,), the proposals
    ``prop`` (2h, ndim) and their stretch factors ``z`` (2h,), the
    proposals' lnp ``lnp_prop`` (2h,) (the posterior calls between the
    gaps write it), each walker's decision ``accepted`` (2h,) uint8 and
    each half's number of them ``counts`` (2,) int64.  Half 0 is the
    first h walkers."""
    x: torch.Tensor
    lnp: torch.Tensor
    prop: torch.Tensor
    z: torch.Tensor
    lnp_prop: torch.Tensor
    accepted: torch.Tensor
    counts: torch.Tensor

    @classmethod
    def around(cls, x, lnp):
        """Buffers around the walkers ``x`` and their ``lnp`` (taken as
        they are, updated in place); the rest allocated on their
        device."""
        nw = x.shape[0]
        return cls(x, lnp, torch.empty_like(x), torch.empty_like(lnp),
                   torch.empty_like(lnp),
                   torch.empty(nw, dtype=torch.uint8, device=x.device),
                   torch.empty(2, dtype=torch.int64, device=x.device))


def _stretch_views(buf, gap, draws):
    """(accept, propose) of one gap as views of ``buf``: accept is None
    or (active, lnp, proposal, z, lnp_prop, u_acc, accepted, count) of
    the half that accepts, the arguments of :func:`stretch_accept_plain`;
    propose is None or (active, other, u, idx, proposal, z) of the half
    that proposes."""
    if gap not in (0, 1, 2):
        raise ValueError(f"stretch_move: gap must be 0, 1 or 2, not {gap}")
    if buf.x.shape[0] % 2:
        raise ValueError("nwalkers must be even (red-black split)")
    h = buf.x.shape[0] // 2
    half = (slice(0, h), slice(h, 2 * h))
    accept = propose = None
    if gap > 0:
        k, s = gap - 1, half[gap - 1]
        accept = (buf.x[s], buf.lnp[s], buf.prop[s], buf.z[s],
                  buf.lnp_prop[s], draws[k][2], buf.accepted[s],
                  buf.counts[k:k + 1])
    if gap < 2:
        s, o = half[gap], half[1 - gap]
        propose = (buf.x[s], buf.x[o], draws[gap][0], draws[gap][1],
                   buf.prop[s], buf.z[s])
    return accept, propose


def _k9_check(buf, accept, propose):
    """(device, h, ndim) of one K9 launch, checked: CUDA, contiguous,
    the buffers' shapes and dtypes and those of the draws the gap reads,
    32-bit indices."""
    f64 = torch.float64
    used = ([(accept[5], f64)] if accept else []) \
        + ([(propose[2], f64), (propose[3], torch.int64)] if propose else [])
    dev = buf.x.device
    if dev.type != "cuda":
        raise ValueError("stretch_move_cuda: K9 takes CUDA tensors")
    if any(t.device != dev or not t.is_contiguous()
           for t in list(buf) + [t for t, _ in used]):
        raise ValueError(f"stretch_move_cuda: every tensor must be "
                         f"contiguous on {dev}")
    nw, nd = buf.x.shape
    h = nw // 2
    if h * nd >= 2**31:
        raise ValueError("stretch_move_cuda: h * ndim must be below 2^31 "
                         "(K9 indexes in 32 bits)")
    if buf.prop.shape != (nw, nd) or buf.x.dtype != f64 \
            or buf.prop.dtype != f64 \
            or any(t.shape != (nw,) or t.dtype != f64
                   for t in (buf.lnp, buf.z, buf.lnp_prop)) \
            or buf.accepted.shape != (nw,) \
            or buf.accepted.dtype != torch.uint8 \
            or buf.counts.shape != (2,) or buf.counts.dtype != torch.int64:
        raise ValueError(
            "stretch_move_cuda: buffers x, prop (2h, ndim) and lnp, z, "
            "lnp_prop (2h,) float64, accepted (2h,) uint8, counts (2,) "
            "int64")
    if any(t.shape != (h,) or t.dtype != dt for t, dt in used):
        raise ValueError("stretch_move_cuda: a half's draws (u, idx, "
                         "u_acc): (h,) float64, int64, float64")
    return dev, h, nd


def stretch_move_cuda(buf, gap, draws, a=2.0):
    """K9 on CUDA tensors, one launch: the arguments as
    :func:`stretch_move`."""
    accept, propose = _stretch_views(buf, gap, draws)
    dev, h, nd = _k9_check(buf, accept, propose)
    acc = [t.data_ptr() for t in accept] if accept else [None] * 8
    pro = [t.data_ptr() for t in propose] if propose else [None] * 6
    K9.launch(dev, int(accept is not None), int(propose is not None), *acc,
              *pro, h, nd, float(a), 1.0 / a)


def stretch_move_plain(buf, gap, draws, a=2.0):
    """K9's plain version, on any device: the accept, then the propose,
    of :func:`stretch_move` in torch ops."""
    accept, propose = _stretch_views(buf, gap, draws)
    if accept is not None:
        stretch_accept_plain(*accept)
    if propose is not None:
        act, oth, u, idx, prop, z = propose
        p, zz = stretch_propose_plain(act, oth, u, idx, a)
        prop.copy_(p)
        z.copy_(zz)


def stretch_move(buf, gap, draws, a=2.0):
    """Gap ``gap`` of a red-black step of the ensemble ``buf``
    (:class:`StretchBuffers`), in place.  Gap 0 proposes half 0 (before
    its posterior call); gap 1 accepts half 0, then proposes half 1
    against the walkers of half 0 as they stand after the accept; gap 2
    accepts half 1 (after its posterior call).  draws: (half 0's, half
    1's), each (u, idx, u_acc), (h,) float64, int64, float64; a gap
    reads only what it uses (half 1's may be None at gap 0).  K9 on
    CUDA, one launch; the plain version on the CPU."""
    dev = buf.x.device
    if dev.type == "cuda":
        return stretch_move_cuda(buf, gap, draws, a)
    if dev.type != "cpu":
        raise ValueError(f"stretch_move: no version for {dev}")
    stretch_move_plain(buf, gap, draws, a)


# --------------------------------------------------------------------------
# the chain
# --------------------------------------------------------------------------

def _injected(draws, nsteps, half, device):
    """The test-only ``draws=`` (u, idx, u_acc), each (nsteps, 2, half),
    on the device, checked on the host."""
    u, idx, u_acc = (np.array(d) for d in draws)
    shape = (nsteps, 2, half)
    if u.shape != shape or idx.shape != shape or u_acc.shape != shape:
        raise ValueError(f"run_mcmc: draws must be (u, idx, u_acc), each "
                         f"{shape}")
    if idx.min() < 0 or idx.max() >= half:
        raise ValueError("run_mcmc: idx outside [0, nwalkers / 2)")
    return (torch.as_tensor(u, dtype=torch.float64, device=device),
            torch.as_tensor(idx, dtype=torch.int64, device=device),
            torch.as_tensor(u_acc, dtype=torch.float64, device=device))


def run_chain(lnpost, x0, nsteps, generator=None, a=2.0, device=None,
              draws=None):
    """The chain of :func:`run_mcmc` with every record, on the host:
    {"chain" (nsteps, nw, ndim), "lnp" (nsteps, nw), "accepted"
    (nsteps, nw) bool, "counts" (nsteps, 2), "lnp_prop" (nsteps, nw),
    the proposals' lnp by walker, "x0", "lnp0"}."""
    dev = resolve_device(device)
    if not isinstance(x0, torch.Tensor):
        x0 = torch.from_numpy(np.array(x0, np.float64))
    x = x0.to(device=dev, dtype=torch.float64).clone().contiguous()
    nw, nd = x.shape
    if nw % 2:
        raise ValueError("nwalkers must be even (red-black split)")
    h = nw // 2
    nsteps = int(nsteps)
    lnpost_v = torch.func.vmap(lnpost)
    lnp = lnpost_v(x).to(torch.float64).contiguous()
    x_init, lnp_init = x.clone(), lnp.clone()
    if draws is not None:
        inj = _injected(draws, nsteps, h, dev)
    elif generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    buf = StretchBuffers.around(x, lnp)
    state = {"step": 0}

    def draw(s, k):
        if draws is not None:
            return inj[0][s, k], inj[1][s, k], inj[2][s, k]
        u = torch.rand(h, generator=generator, dtype=torch.float64,
                       device=dev)
        idx = torch.randint(0, h, (h,), generator=generator, device=dev)
        return u, idx, torch.rand(h, generator=generator,
                                  dtype=torch.float64, device=dev)

    def body(st):
        # three K9 launches a step, one per gap between posterior calls;
        # the draws in the generator's order u, idx, u_acc per half
        s = st["step"]
        d0 = draw(s, 0)
        stretch_move(buf, 0, (d0, None), a)
        buf.lnp_prop[:h].copy_(lnpost_v(buf.prop[:h]))
        d = (d0, draw(s, 1))
        stretch_move(buf, 1, d, a)
        buf.lnp_prop[h:].copy_(lnpost_v(buf.prop[h:]))
        stretch_move(buf, 2, d, a)
        st["step"] = s + 1
        return st

    def record(_prev, _st):
        return (x.clone(), lnp.clone(), buf.accepted.clone(),
                buf.counts.clone(), buf.lnp_prop.clone())

    _, rec = iterate_fixed(body, state, nsteps, trace_of=record)
    if rec is None:
        rec = (x.new_zeros((0, nw, nd)), x.new_zeros((0, nw)),
               torch.zeros((0, nw), dtype=torch.uint8),
               torch.zeros((0, 2), dtype=torch.int64), x.new_zeros((0, nw)))
    chain, lnps, acc, counts, lnp_prop = (t.cpu().numpy() for t in rec)
    return {"chain": chain, "lnp": lnps, "accepted": acc.astype(bool),
            "counts": counts, "lnp_prop": lnp_prop,
            "x0": x_init.cpu().numpy(), "lnp0": lnp_init.cpu().numpy()}


def decision_margins(out, draws, a=2.0):
    """(margin, lnp_prop, lnp_before), each (nsteps, 2, nwalkers / 2), of
    every accept decision of a :func:`run_chain` output ``out`` run with
    ``draws``: margin = lnratio - log u_acc (the decision accepts where
    it is positive), on the host in numpy."""
    u, _, u_acc = (np.asarray(d, np.float64) for d in draws)
    nsteps, _, h = u.shape
    nd = out["x0"].shape[1]
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    lnp_prop = out["lnp_prop"].reshape(nsteps, 2, h)
    before = np.concatenate([out["lnp0"][None], out["lnp"][:-1]])
    before = before.reshape(nsteps, 2, h)
    with np.errstate(invalid="ignore"):
        margin = (nd - 1.0) * np.log(z) + lnp_prop - before - np.log(u_acc)
    return margin, lnp_prop, before


def run_mcmc(lnpost, x0, nsteps, generator=None, a=2.0, thin=1,
             device=None, draws=None, mesh=None):
    """Run an ensemble chain on ``device`` (CUDA unless given).

    lnpost: f(vec (ndim,)) -> scalar log-posterior, batched over walkers
    by ``torch.func.vmap``.  x0: (nwalkers, ndim), nwalkers even.
    generator: a ``torch.Generator`` on the device (default: one seeded
    0).  draws: test-only (u, idx, u_acc) host arrays, each (nsteps, 2,
    nwalkers / 2), that replace the generator's numbers.  Returns (chain
    (nsteps // thin, nwalkers, ndim), lnp (nsteps // thin, nwalkers),
    acceptance rate) as numpy arrays and a float; raises
    :class:`FitDivergedError` when the chain ends with a non-finite
    walker or with no finite lnp."""
    if mesh is not None:
        raise NotImplementedError(
            "run_mcmc(mesh=): walkers sharded over cards are not ported "
            "(ROADMAP queue 1 item 14)")
    out = run_chain(lnpost, x0, nsteps, generator=generator, a=a,
                    device=device, draws=draws)
    return _finish(out, thin)


def _finish(out, thin):
    chain, lnps = out["chain"], out["lnp"]
    xf = chain[-1] if len(chain) else out["x0"]
    lnpf = lnps[-1] if len(lnps) else out["lnp0"]
    # the chain-health verdict (pint_tpu sampler.py:295-337)
    health = {"positions_finite": bool(np.all(np.isfinite(xf))),
              "any_finite_lnp": bool(np.any(np.isfinite(lnpf)))}
    if not all(health.values()):
        raise FitDivergedError(
            "sampler.run_mcmc: chain diverged (non-finite walker positions "
            "or every walker at lnp=-inf); .last_good carries the initial "
            "ensemble", health=health, last_good=out["x0"])
    nw = chain.shape[1] if chain.ndim == 3 else 1
    acc = float(np.mean(out["counts"].sum(axis=1) / nw)) if len(chain) \
        else float("nan")
    if thin > 1:
        chain, lnps = chain[::thin], lnps[::thin]
    return chain, lnps, acc


class EnsembleSampler:
    """Holds (lnpost, nwalkers) and a generator on the device; starts
    walkers from a Gaussian ball, runs, exposes the chain (pint_tpu
    sampler.py:339)."""

    def __init__(self, lnpost, nwalkers=32, seed=0, device=None,
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "EnsembleSampler(mesh=): walkers sharded over cards are not "
                "ported (ROADMAP queue 1 item 14)")
        self.lnpost = lnpost
        self.nwalkers = int(nwalkers)
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(seed))
        self.chain = None
        self.lnprob = None
        self.acceptance = None

    def initial_ball(self, center, scale):
        """Walkers (nwalkers, ndim) in a Gaussian ball around
        ``center``, on the device."""
        center = torch.as_tensor(np.asarray(center, np.float64),
                                 device=self.device)
        scale = torch.as_tensor(np.asarray(scale, np.float64),
                                device=self.device)
        return center + scale * torch.randn(
            (self.nwalkers, center.shape[0]), generator=self.generator,
            dtype=torch.float64, device=self.device)

    def _chunk(self, x0, nsteps):
        out = run_chain(self.lnpost, x0, nsteps, generator=self.generator,
                        device=self.device)
        return _finish(out, 1)

    def run_mcmc(self, x0, nsteps, thin=1):
        chain, lnp, acc = self._chunk(x0, nsteps)
        self.chain = chain[::thin] if thin > 1 else chain
        self.lnprob = lnp[::thin] if thin > 1 else lnp
        self.acceptance = acc
        return self.chain

    def run_mcmc_autocorr(self, x0, chunk=100, maxsteps=5000,
                          tau_factor=50.0, rtol=0.1, checkpoint=None,
                          checkpoint_meta=None):
        """Run in chunks until converged by the emcee criterion (pint_tpu
        sampler.py:389): the chain longer than ``tau_factor`` integrated
        autocorrelation times and tau changed by < ``rtol`` between
        chunks; give up at ``maxsteps``.  Returns (chain, converged,
        tau)."""
        if checkpoint is not None or checkpoint_meta is not None:
            raise NotImplementedError(
                "run_mcmc_autocorr(checkpoint=): the guard's checkpoint "
                "files are not ported (ROADMAP queue 1 item 2)")
        chains, lnprobs, accs = [], [], []
        tau_prev = None
        tau = np.array([np.inf])
        converged = False
        x = x0
        total = 0
        acache = AutocorrCache(lag0=max(64, int(chunk)))
        while total < maxsteps:
            step = int(min(chunk, maxsteps - total))
            chain, lnprob, acc = self._chunk(x, step)
            chains.append(chain)
            lnprobs.append(lnprob)
            accs.append((acc, step))
            x = chain[-1]
            total += step
            acache.update(chain)
            tau = acache.tau(np.concatenate(chains, axis=0))
            if (np.all(np.isfinite(tau))
                    and total > tau_factor * np.max(tau)
                    and tau_prev is not None
                    and np.all(np.abs(tau - tau_prev)
                               < rtol * np.maximum(tau, 1e-12))):
                converged = True
                break
            tau_prev = tau
        self.chain = np.concatenate(chains, axis=0)
        self.lnprob = np.concatenate(lnprobs, axis=0)
        # whole-run mean acceptance, weighted by chunk length
        self.acceptance = (sum(a * n for a, n in accs)
                           / sum(n for _, n in accs))
        return self.chain, converged, tau

    def flatchain(self, burn=0):
        c = np.asarray(self.chain[burn:])
        return c.reshape(-1, c.shape[-1])

    def max_posterior(self):
        lnp = np.asarray(self.lnprob)
        i, j = np.unravel_index(np.argmax(lnp), lnp.shape)
        return np.asarray(self.chain[i, j]), float(lnp[i, j])
