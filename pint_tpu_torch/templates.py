"""Photon light-curve templates: wrapped mixture models and their
maximum-likelihood fit (pint_tpu templates.py).

A template is k primitives with amplitudes norms_k plus the uniform
background 1 - sum(norms); the photon log-likelihood (Kerr 2011) is

    lnL = sum_i log( max(w_i f(phi_i) + (1 - w_i), 1e-300) ).

Two implementations of the density and of lnL, chosen by the device of
the phases:

- CUDA: kernel K12 (``csrc/photon_lnlike.cu``) evaluates the mixture and
  its clamped log-sum per (walker, photon), with K12b its backward.  The
  per-walker scalar work (the background, sigma sqrt(2 pi), sinh and
  cosh of 2 pi gamma, i0e(kappa), the two-sided weights) runs in torch
  first (:func:`pack_template`), so autograd chains through it.  lnL is
  the custom op ``pint_tpu_torch::photon_lnlike``, with a batching rule
  (``torch.func.vmap`` over walkers is one K12 launch set) and K12b as
  its backward.  K12 covers LCGaussian, LCLorentzian, LCVonMises,
  LCGaussian2, LCLorentzian2 and the MCMC's binned profile; a template
  with another primitive raises on a CUDA tensor.
- CPU: the plain PyTorch versions below, the JAX formulas step by step
  (:func:`photon_density_plain`, :func:`photon_lnlike_plain` and
  :func:`photon_lnlike_bwd_plain`, the analytic backward K12b computes),
  and every primitive's own ``density``.

:class:`LCFitter` fits a template with scipy's L-BFGS-B on the host, fed
K12's value and K12b's gradient on the card.  Not ported: the
energy-dependent templates (``LCEWrapped`` and its subclasses,
``ENormAngles``, ``LCETemplate``, ``LCEFitter``) and, on the card,
``LCFitter.param_uncertainties`` (a double backward of K12b), which
raise (ROADMAP queue 1 item 14).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch._cuda import CudaKernel

__all__ = [
    "LCGaussian", "LCLorentzian", "LCVonMises", "LCTopHat",
    "LCHarmonic", "LCGaussian2", "LCLorentzian2", "LCSkewGaussian",
    "LCKing", "LCEmpiricalFourier", "LCKernelDensity",
    "LCTemplate", "LCFitter", "NormAngles",
    "LCEGaussian", "LCETemplate", "LCEFitter", "ENormAngles",
    "LCEWrapped", "LCESkewGaussian", "LCELorentzian",
    "LCELorentzian2", "LCEGaussian2", "LCEVonMises",
    "read_template", "write_template", "prof_string",
    "read_gaussfitfile", "convert_primitive",
    "pack_template", "photon_density", "photon_lnlike",
    "photon_density_plain", "photon_lnlike_plain", "photon_log_terms",
    "photon_lnlike_bwd_plain", "K12", "K12B",
]

#: FWHM = _FWHM_SIGMA * sigma for a Gaussian
_FWHM_SIGMA = 2.3548200450309493

#: numpy 2 renamed trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz

#: wraps in the wrapped-Gaussian sum (pint_tpu templates.py:50)
_NWRAP = 3
_TWO_PI = 2.0 * math.pi
_SQRT_2PI = math.sqrt(2.0 * math.pi)
_F64 = torch.float64

#: the clamp of the log-sum, kept a float64 tensor op
_FLOOR = 1e-300

#: K12's component type codes and its packed row width
K12_GAUSS, K12_LOR, K12_VM, K12_GAUSS2, K12_LOR2 = range(5)
K12_ROW = 8

#: kernel K12 (replaces pint_tpu/templates.py:525 LCTemplate.lnlike_fn)
K12 = CudaKernel(
    "photon_lnlike", "photon_lnlike.cu", "photon_lnlike_launch",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
     ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
     ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
     ctypes.c_int64])
#: kernel K12b, K12's backward (replaces jax.grad of lnlike_fn,
#: pint_tpu/templates.py:570 LCFitter._val_grad)
K12B = CudaKernel(
    "photon_lnlike_bwd", "photon_lnlike.cu", "photon_lnlike_bwd_launch",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
     ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int64, ctypes.c_int64])


def _unported(what):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1 item 14)")


def _t(x, like=None, device=None):
    """float64 tensor of ``x`` on ``like``'s device (or ``device``)."""
    if isinstance(x, torch.Tensor):
        return x.to(_F64)
    dev = like.device if like is not None else device
    return torch.as_tensor(np.asarray(x, np.float64), device=dev)


def _wrapped_gauss(t, s, c):
    """sum_k exp(-0.5 ((t + k)/s)^2) / c over k = -3..3, added in order
    (K12's order)."""
    acc = torch.zeros_like(t + s)
    for k in range(-_NWRAP, _NWRAP + 1):
        z = (t + float(k)) / s
        acc = acc + torch.exp(-0.5 * (z * z))
    return acc / c


def _two_sided_d(phi, loc):
    """d = ((phi - loc + 0.5) mod 1) - 0.5, in [-0.5, 0.5)."""
    return torch.remainder((phi - loc) + 0.5, 1.0) - 0.5


def _packed_density(prim, phi, p):
    """A K12-covered primitive's density at ``phi``: its packed row (norm
    1) through :func:`k12_component_density`."""
    row = prim.k12_row([p[j] for j in range(prim.n_params)],
                       torch.ones_like(p[0]))
    return k12_component_density(prim.k12_type, row, phi)


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

@dataclass
class LCGaussian:
    """Wrapped Gaussian peak: width sigma, location loc (turns)."""

    sigma: float = 0.03
    loc: float = 0.5

    n_params = 2
    loc_index = 1
    k12_type = K12_GAUSS

    def density(self, phi, p):
        return _packed_density(self, phi, p)

    def k12_row(self, p, norm):
        z = torch.zeros_like(norm)
        return [norm, p[1], p[0], p[0] * _SQRT_2PI, z, z, z, z]

    def init_params(self):
        return [self.sigma, self.loc]

    def param_bounds(self):
        return [(1e-3, 0.5), (None, None)]


@dataclass
class LCLorentzian:
    """Wrapped Lorentzian peak: HWHM gamma, location loc (turns); the
    wrap sum's closed form sinh(2 pi g) / (cosh(2 pi g) - cos(2 pi (phi
    - loc)))."""

    gamma: float = 0.03
    loc: float = 0.5

    n_params = 2
    loc_index = 1
    k12_type = K12_LOR

    def density(self, phi, p):
        return _packed_density(self, phi, p)

    def k12_row(self, p, norm):
        z = torch.zeros_like(norm)
        return [norm, p[1], torch.sinh(_TWO_PI * p[0]),
                torch.cosh(_TWO_PI * p[0]), z, z, z, z]

    def init_params(self):
        return [self.gamma, self.loc]

    def param_bounds(self):
        return [(1e-3, 0.5), (None, None)]


@dataclass
class LCVonMises:
    """Von Mises peak: concentration kappa, location loc;
    exp(kappa (cos a - 1)) / i0e(kappa)."""

    kappa: float = 100.0
    loc: float = 0.5

    n_params = 2
    loc_index = 1
    k12_type = K12_VM

    def density(self, phi, p):
        return _packed_density(self, phi, p)

    def k12_row(self, p, norm):
        z = torch.zeros_like(norm)
        return [norm, p[1], p[0], torch.special.i0e(p[0]), z, z, z, z]

    def init_params(self):
        return [self.kappa, self.loc]

    def param_bounds(self):
        return [(1e-1, 1e7), (None, None)]


@dataclass
class LCTopHat:
    """Top hat of full width ``width`` (turns) centered at loc."""

    width: float = 0.1
    loc: float = 0.5

    n_params = 2
    loc_index = 1
    k12_type = None

    def density(self, phi, p):
        width, loc = p[0], p[1]
        d = torch.abs(torch.remainder((phi - loc) + 0.5, 1.0) - 0.5)
        inv = 1.0 / width
        return torch.where(d <= width / 2.0, inv, torch.zeros_like(inv))

    def init_params(self):
        return [self.width, self.loc]

    def param_bounds(self):
        return [(1e-3, 1.0), (None, None)]


@dataclass
class LCHarmonic:
    """Pure cosine harmonic of fixed order: 1 + cos(2 pi n (phi -
    loc))."""

    order: int = 1
    loc: float = 0.0

    n_params = 1
    loc_index = 0
    k12_type = None

    def density(self, phi, p):
        return 1.0 + torch.cos(_TWO_PI * self.order * (phi - p[0]))

    def init_params(self):
        return [self.loc]

    def param_bounds(self):
        return [(None, None)]


@dataclass
class LCGaussian2:
    """Two-sided wrapped Gaussian: sigma1 (leading), sigma2 (trailing)."""

    sigma1: float = 0.03
    sigma2: float = 0.03
    loc: float = 0.5

    n_params = 3
    loc_index = 2
    k12_type = K12_GAUSS2

    def density(self, phi, p):
        return _packed_density(self, phi, p)

    def k12_row(self, p, norm):
        s1, s2 = p[0], p[1]
        return [norm, p[2], s1, s2, s1 * _SQRT_2PI, s2 * _SQRT_2PI,
                2.0 * s1 / (s1 + s2), 2.0 * s2 / (s1 + s2)]

    def init_params(self):
        return [self.sigma1, self.sigma2, self.loc]

    def param_bounds(self):
        return [(1e-3, 0.5), (1e-3, 0.5), (None, None)]


@dataclass
class LCLorentzian2:
    """Two-sided wrapped Lorentzian: gamma1/gamma2 HWHM."""

    gamma1: float = 0.03
    gamma2: float = 0.03
    loc: float = 0.5

    n_params = 3
    loc_index = 2
    k12_type = K12_LOR2

    def density(self, phi, p):
        return _packed_density(self, phi, p)

    def k12_row(self, p, norm):
        g1, g2 = p[0], p[1]
        return [norm, p[2], torch.sinh(_TWO_PI * g1),
                torch.cosh(_TWO_PI * g1), torch.sinh(_TWO_PI * g2),
                torch.cosh(_TWO_PI * g2), 2.0 * g1 / (g1 + g2),
                2.0 * g2 / (g1 + g2)]

    def init_params(self):
        return [self.gamma1, self.gamma2, self.loc]

    def param_bounds(self):
        return [(1e-3, 0.5), (1e-3, 0.5), (None, None)]


@dataclass
class LCSkewGaussian:
    """Wrapped skew-normal peak: 2 pdf(z) cdf(shape z) / sigma, z = (x -
    loc)/sigma, over +-3 wraps."""

    sigma: float = 0.03
    shape: float = 2.0
    loc: float = 0.5

    n_params = 3
    loc_index = 2
    k12_type = None

    def density(self, phi, p):
        sigma, shape, loc = p[0], p[1], p[2]
        k = torch.arange(-_NWRAP, _NWRAP + 1, dtype=_F64, device=phi.device)
        z = ((phi - loc)[..., None] + k) / sigma[..., None]
        pdf = torch.exp(z * z / -2.0) / _SQRT_2PI
        f = 2.0 * pdf * torch.special.ndtr(shape[..., None] * z) \
            / sigma[..., None]
        return torch.sum(f, dim=-1)

    def init_params(self):
        return [self.sigma, self.shape, self.loc]

    def param_bounds(self):
        return [(1e-3, 0.5), (-30.0, 30.0), (None, None)]


@dataclass
class LCKing:
    """Wrapped King-function peak: N (1 + x^2/(2 sigma^2 gamma))^(-gamma),
    normalized over the real line, wrapped over +-9 turns."""

    sigma: float = 0.03
    gamma: float = 3.0
    loc: float = 0.5

    n_params = 3
    loc_index = 2
    k12_type = None

    def density(self, phi, p):
        sigma, gamma, loc = p[0], p[1], p[2]
        norm = torch.exp(torch.lgamma(gamma) - torch.lgamma(gamma - 0.5)) / (
            torch.sqrt(_TWO_PI * gamma) * sigma)
        k = torch.arange(-3 * _NWRAP, 3 * _NWRAP + 1, dtype=_F64,
                         device=phi.device)
        z = ((phi - loc)[..., None] + k) / sigma[..., None]
        f = norm[..., None] * (1.0 + z * z / (2.0 * gamma[..., None])) \
            ** (-gamma[..., None])
        return torch.sum(f, dim=-1)

    def init_params(self):
        return [self.sigma, self.gamma, self.loc]

    def param_bounds(self):
        return [(1e-3, 0.5), (1.01, 50.0), (None, None)]


class LCEmpiricalFourier:
    """Non-parametric Fourier light curve: harmonic coefficients from a
    photon phase sample (or a ``# fourier`` file); the one parameter is
    an overall phase shift.  Use it alone with norm 1."""

    n_params = 1
    loc_index = 0
    k12_type = None

    def __init__(self, phases=None, input_file=None, nharm=20):
        self.nharm = int(nharm)
        self.shift = 0.0
        self.alphas = np.zeros(self.nharm)
        self.betas = np.zeros(self.nharm)
        if input_file is not None:
            self.from_file(input_file)
        if phases is not None:
            self.from_phases(phases)

    def from_phases(self, phases):
        phases = np.asarray(phases, np.float64) % 1.0
        k = np.arange(1, self.nharm + 1) * 2.0 * np.pi
        self.alphas = np.cos(k[:, None] * phases[None, :]).mean(axis=1)
        self.betas = np.sin(k[:, None] * phases[None, :]).mean(axis=1)

    def from_file(self, path):
        rows = []
        with open(path, "r") as f:
            for line in f:
                if "#" in line:
                    continue
                toks = line.split()
                if len(toks) == 2:
                    try:
                        rows.append((float(toks[0]), float(toks[1])))
                    except ValueError:
                        pass
        if not rows:
            raise ValueError(f"no fourier coefficients in {path}")
        self.alphas = np.array([r[0] for r in rows])
        self.betas = np.array([r[1] for r in rows])
        self.nharm = len(rows)

    def to_file(self, path):
        with open(path, "w") as f:
            f.write("# fourier\n")
            for a, b in zip(self.alphas, self.betas):
                f.write(f"{float(a)!r}\t{float(b)!r}\n")

    def density(self, phi, p):
        shift = p[0]
        k = torch.arange(1, self.nharm + 1, dtype=_F64,
                         device=phi.device) * 2.0 * math.pi
        c, s = torch.cos(k * shift), torch.sin(k * shift)
        al = torch.as_tensor(self.alphas, dtype=_F64, device=phi.device)
        be = torch.as_tensor(self.betas, dtype=_F64, device=phi.device)
        a = c * al - s * be
        b = s * al + c * be
        ph = phi[..., None] * k
        return 1.0 + 2.0 * torch.sum(a * torch.cos(ph) + b * torch.sin(ph),
                                     dim=-1)

    def init_params(self):
        return [self.shift]

    def param_bounds(self):
        return [(None, None)]


def _interp(x, xp, fp):
    """jnp.interp(x, xp, fp) with constant ends, in torch."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float64).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (
        delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class LCKernelDensity:
    """Non-parametric kernel-density light curve: a wrapped-Gaussian KDE
    of a photon phase sample on a grid, linearly interpolated; the one
    parameter is an overall shift.  Use it alone with norm 1."""

    n_params = 1
    loc_index = 0
    k12_type = None

    def __init__(self, phases=None, bw=None, resolution=0.001):
        self.shift = 0.0
        self.resolution = float(resolution)
        self.bw = bw
        self.grid = np.linspace(0.0, 1.0,
                                int(round(1.0 / self.resolution)) + 1)
        self.vals = np.ones_like(self.grid)
        if phases is not None:
            self.from_phases(phases)

    def from_phases(self, phases):
        phases = np.asarray(phases, np.float64) % 1.0
        n = len(phases)
        bw = self.bw if self.bw is not None else 1.06 * min(
            np.std(phases), 0.2) * n ** (-0.2)
        bw = max(float(bw), 1e-3)
        self.bw = bw
        d = self.grid[:, None] - phases[None, :]
        acc = np.zeros(len(self.grid))
        for k in (-1, 0, 1):
            acc += np.exp(-0.5 * ((d + k) / bw) ** 2).sum(axis=1)
        vals = acc / (n * bw * np.sqrt(2 * np.pi))
        self.vals = vals / _trapezoid(vals, self.grid)

    def density(self, phi, p):
        ph = torch.remainder(phi - p[0], 1.0)
        return _interp(ph, torch.as_tensor(self.grid, device=phi.device),
                       torch.as_tensor(self.vals, device=phi.device))

    def init_params(self):
        return [self.shift]

    def param_bounds(self):
        return [(None, None)]


class NormAngles:
    """Constrained normalizations (reference lcnorm.py NormAngles): k
    amplitudes through angles, every norm in (0, 1) and their sum below
    1 for any angles."""

    def __init__(self, k):
        self.k = k

    def to_norms(self, angles):
        """angles (k,) -> norms (k,) by stick-breaking."""
        angles = _t(angles, device="cpu")
        total = torch.sin(angles[0]) ** 2
        rest = angles[1:]
        parts = []
        remaining = total
        for i in range(self.k - 1):
            frac = torch.sin(rest[i]) ** 2
            parts.append(remaining * frac)
            remaining = remaining * (1.0 - frac)
        parts.append(remaining)
        return torch.stack(parts)

    def from_norms(self, norms):
        norms = np.asarray(norms, dtype=np.float64)
        total = norms.sum()
        angles = [np.arcsin(np.sqrt(np.clip(total, 1e-9, 1 - 1e-9)))]
        remaining = total
        for i in range(self.k - 1):
            frac = norms[i] / max(remaining, 1e-12)
            angles.append(np.arcsin(np.sqrt(np.clip(frac, 1e-9,
                                                    1 - 1e-9))))
            remaining -= norms[i]
        return np.array(angles)


# --------------------------------------------------------------------------
# kernel K12 and its plain versions
# --------------------------------------------------------------------------

def pack_template(template, params):
    """(types (C,) int32, rows (..., C, 8), bg (...)) of ``template`` at
    ``params`` (..., n_params): K12's packed rows, computed in torch so
    autograd chains through them.  Raises for a primitive K12 does not
    cover."""
    template._require_k12()
    norms, prim_params = template._split(params)
    codes, rows = [], []
    for i, prim in enumerate(template.primitives):
        pp = [prim_params[i][..., j] for j in range(prim.n_params)]
        codes.append(prim.k12_type)
        rows.append(torch.stack(prim.k12_row(pp, norms[..., i]), dim=-1))
    bg = 1.0 - torch.sum(norms, dim=-1)
    # the codes' tensor is kept per device: a posterior call copies
    # nothing from the host
    key = (tuple(codes), str(params.device))
    cache = template.__dict__.setdefault("_k12_types", {})
    if key not in cache:
        cache[key] = torch.tensor(codes, dtype=torch.int32,
                                  device=params.device)
    return cache[key], torch.stack(rows, dim=-2), bg


def photon_density_plain(frac, types, rows, bg, bins=None, wrap=False):
    """The plain version of K12's density: f (W, N) of phases ``frac``
    (Wp, N) under packed rows ``rows`` (Wq, C, 8) and background ``bg``
    (Wq,), or of the binned profile ``bins`` (nbins,) (already divided
    by its mean).  ``wrap`` floor-mods the phases by 1 first."""
    phi = torch.remainder(frac, 1.0) if wrap else frac
    if bins is not None:
        nb = bins.shape[0]
        idx = torch.clamp((torch.remainder(phi, 1.0) * float(nb)).to(
            torch.int32), 0, nb - 1)
        return bins[idx.to(torch.int64)]
    f = bg[..., None]
    for c, t in enumerate(types.tolist()):
        p = [rows[..., c, k][..., None] for k in range(K12_ROW)]
        f = f + p[0] * k12_component_density(t, p, phi)
    return f


def k12_component_density(t, p, phi):
    """One component's density (its norm aside) of K12 type ``t`` at
    ``phi`` from its packed row ``p`` (8 tensors that broadcast with
    ``phi``): the only CPU formula of each type K12 covers, which the
    primitives' ``density`` reaches through their own row.  The
    two-sided types scale each side's core by 2 w_side / (w1 + w2), so
    that each half carries weight 1/2 (pint_tpu templates.py:177)."""
    if t == K12_GAUSS:
        return _wrapped_gauss(phi - p[1], p[2], p[3])
    if t == K12_LOR:
        return p[2] / (p[3] - torch.cos(_TWO_PI * (phi - p[1])))
    if t == K12_VM:
        return torch.exp(p[2] * (torch.cos(_TWO_PI * (phi - p[1])) - 1.0)) \
            / p[3]
    if t == K12_GAUSS2:
        dd = _two_sided_d(phi, p[1])
        return torch.where(dd < 0, p[6] * _wrapped_gauss(dd, p[2], p[4]),
                           p[7] * _wrapped_gauss(dd, p[3], p[5]))
    if t == K12_LOR2:
        dd = _two_sided_d(phi, p[1])
        cd = torch.cos(_TWO_PI * dd)
        return torch.where(dd < 0, p[6] * (p[2] / (p[3] - cd)),
                           p[7] * (p[4] / (p[5] - cd)))
    raise ValueError(f"K12 type code {t}")


def _photon_x(f, weights):
    return f if weights is None else weights * f + (1.0 - weights)


def photon_log_terms(f, weights):
    """Each photon's log(max(w f + (1 - w), 1e-300)) (log(max(f, 1e-300))
    without weights), the clamp a float64 tensor op (with a Python
    scalar ``torch.where`` computes in float32, where 1e-300 is 0)."""
    x = _photon_x(f, weights)
    return torch.log(torch.maximum(x, torch.tensor(_FLOOR, dtype=_F64,
                                                   device=x.device)))


def photon_lnlike_plain(frac, weights, types, rows, bg, bins=None,
                        wrap=False, absolute=False):
    """The plain version of K12: lnL (W,) = sum over photons of
    log(max(w f + (1 - w), 1e-300)) (or log(max(f, 1e-300)) without
    weights), f from :func:`photon_density_plain`.  ``absolute`` sums
    |log x| instead (the scale of the sum's rounding)."""
    t = photon_log_terms(photon_density_plain(frac, types, rows, bg, bins,
                                              wrap), weights)
    return torch.sum(torch.abs(t) if absolute else t, dim=-1)


def _wrap_sums(t, s):
    """(sum e, sum e z, sum e z^2) over the 7 wraps, e = exp(-z^2/2), z =
    (t + k)/s, added in order."""
    e0 = e1 = e2 = torch.zeros_like(t + s)
    for k in range(-_NWRAP, _NWRAP + 1):
        z = (t + float(k)) / s
        e = torch.exp(-0.5 * (z * z))
        e0 = e0 + e
        e1 = e1 + e * z
        e2 = e2 + e * (z * z)
    return e0, e1, e2


def photon_lnlike_bwd_plain(frac, weights, types, rows, bg, wrap=False,
                            absolute=False):
    """The plain version of K12b: (W, 1 + 8 C) of d lnL_w / d(bg, packed
    rows), sum over photons of g_i df_i/dtheta, g_i = w_i / x_i (1 / x_i
    without weights), 0 where the clamp holds.  The derivatives are
    K12b's formulas (``csrc/photon_lnlike.cu`` comp_grad) in torch.
    ``absolute`` sums |g_i df_i/dtheta| instead (the scale of each
    entry's rounding)."""
    phi = torch.remainder(frac, 1.0) if wrap else frac
    x = _photon_x(photon_density_plain(frac, types, rows, bg, None, wrap),
                  weights)
    num = torch.ones_like(x) if weights is None else \
        weights.expand_as(x)
    g = torch.where(x > _FLOOR, num / x, torch.zeros_like(x))
    W = g.shape[0]
    if absolute:
        g = torch.abs(g)
    out = [torch.sum(g, dim=-1)]
    zero = torch.zeros_like(g)
    for c, t in enumerate(types.tolist()):
        p = [rows[..., c, k][..., None] for k in range(K12_ROW)]
        norm = p[0]
        s = [zero] * K12_ROW
        if t == K12_GAUSS:
            e0, e1, e2 = _wrap_sums(phi - p[1], p[2])
            c_ = p[3]
            s[:4] = [e0 / c_, norm * ((e1 / p[2]) / c_),
                     norm * ((e2 / p[2]) / c_), -norm * ((e0 / c_) / c_)]
        elif t == K12_LOR:
            a = _TWO_PI * (phi - p[1])
            den = p[3] - torch.cos(a)
            dens = p[2] / den
            s[:4] = [dens, norm * ((_TWO_PI * torch.sin(a)) * (dens / den)),
                     norm / den, -norm * (dens / den)]
        elif t == K12_VM:
            ang = _TWO_PI * (phi - p[1])
            ca = torch.cos(ang) - 1.0
            dens = torch.exp(p[2] * ca) / p[3]
            s[:4] = [dens, norm * (dens * (p[2] * (_TWO_PI * torch.sin(ang)))),
                     norm * (dens * ca), -norm * (dens / p[3])]
        elif t in (K12_GAUSS2, K12_LOR2):
            d = _two_sided_d(phi, p[1])
            left = d < 0
            for side, sel in ((0, left), (1, ~left)):
                w = p[6 + side]
                nw = norm * w
                if t == K12_GAUSS2:
                    sg, cg = p[2 + side], p[4 + side]
                    e0, e1, e2 = _wrap_sums(d, sg)
                    core = e0 / cg
                    loc_g = nw * ((e1 / sg) / cg)
                    slots = {2 + side: nw * ((e2 / sg) / cg),
                             4 + side: -nw * (core / cg)}
                else:
                    sh, ch = p[2 + 2 * side], p[3 + 2 * side]
                    a = _TWO_PI * d
                    den = ch - torch.cos(a)
                    core = sh / den
                    loc_g = nw * ((_TWO_PI * torch.sin(a)) * (core / den))
                    slots = {2 + 2 * side: nw / den,
                             3 + 2 * side: -nw * (core / den)}
                slots.update({0: w * core, 1: loc_g, 6 + side: norm * core})
                for k, v in slots.items():
                    s[k] = s[k] + torch.where(sel, v, zero)
        else:
            raise ValueError(f"K12 type code {t}")
        out += [torch.sum(g * (torch.abs(v) if absolute else v), dim=-1)
                for v in s]
    return torch.stack(out, dim=-1).reshape(W, 1 + K12_ROW * len(types))


def _k12_check(frac, weights, types, rows, bg, bins):
    """(device, W, N, row strides) of a K12 launch, checked."""
    dev = frac.device
    if dev.type != "cuda":
        raise ValueError("photon_lnlike_cuda: K12 takes CUDA tensors")
    ts = [frac, types, rows, bg] + [t for t in (weights, bins)
                                     if t is not None]
    if any(t.device != dev for t in ts):
        raise ValueError(f"photon_lnlike_cuda: every tensor on {dev}")
    if frac.dim() != 2 or rows.dim() != 3 or rows.shape[-1] != K12_ROW \
            or bg.dim() != 1 or bg.shape[0] != rows.shape[0]:
        raise ValueError("photon_lnlike_cuda: frac (Wp, N), rows (Wq, C, "
                         "8), bg (Wq,)")
    if any(t.dtype != _F64 for t in (frac, rows, bg)) \
            or types.dtype != torch.int32 \
            or any(t.dtype != _F64 for t in (weights, bins)
                   if t is not None):
        raise ValueError("photon_lnlike_cuda: float64 phases, rows, bg, "
                         "weights and bins, int32 types")
    wp, n = frac.shape
    wq, c = rows.shape[0], rows.shape[1]
    w = max(wp, wq)
    if wp not in (1, w) or wq not in (1, w) or types.shape != (c,):
        raise ValueError("photon_lnlike_cuda: phase and parameter rows "
                         "are 1 or one per walker")
    if weights is not None and weights.shape != (n,):
        raise ValueError("photon_lnlike_cuda: weights (N,)")
    if bins is None and c == 0:
        raise ValueError("photon_lnlike_cuda: no components and no bins")
    if w > 65535 or n >= 2**40:
        raise ValueError("photon_lnlike_cuda: at most 65535 walkers")
    return dev, w, n, (n if wp > 1 else 0), \
        (c * K12_ROW if wq > 1 else 0), (1 if wq > 1 else 0)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _contig(*ts):
    return [None if t is None else t.contiguous() for t in ts]


def photon_lnlike_cuda(frac, weights, types, rows, bg, bins=None,
                       wrap=False, density=False):
    """K12 on CUDA tensors, one launch set: lnL (W,), or with
    ``density`` f (W, N).  Arguments as :func:`photon_lnlike_plain`."""
    frac, weights, types, rows, bg, bins = _contig(
        frac, weights, types, rows, bg, bins)
    dev, w, n, f_rs, p_rs, b_rs = _k12_check(frac, weights, types, rows,
                                             bg, bins)
    nblk = -(-n // 2048)
    partial = torch.empty((w, max(nblk, 1)), dtype=_F64, device=dev)
    out = torch.empty((w, n) if density else (w,), dtype=_F64, device=dev)
    K12.launch(dev, frac.data_ptr(), f_rs, _ptr(weights), types.data_ptr(),
               rows.shape[1], rows.data_ptr(), p_rs, bg.data_ptr(), b_rs,
               _ptr(bins), 0 if bins is None else bins.shape[0], int(wrap),
               int(density), partial.data_ptr(), out.data_ptr(), w, n)
    return out


def photon_lnlike_bwd_cuda(frac, weights, types, rows, bg, wrap=False):
    """K12b on CUDA tensors, one launch set: (W, 1 + 8 C) as
    :func:`photon_lnlike_bwd_plain`."""
    frac, weights, types, rows, bg = _contig(frac, weights, types, rows, bg)
    dev, w, n, f_rs, p_rs, b_rs = _k12_check(frac, weights, types, rows,
                                             bg, None)
    q = 1 + K12_ROW * rows.shape[1]
    nblk = -(-n // 2048)
    partial = torch.empty((w, max(nblk, 1), q), dtype=_F64, device=dev)
    out = torch.empty((w, q), dtype=_F64, device=dev)
    K12B.launch(dev, frac.data_ptr(), f_rs, _ptr(weights), types.data_ptr(),
                rows.shape[1], rows.data_ptr(), p_rs, bg.data_ptr(), b_rs,
                int(wrap), partial.data_ptr(), out.data_ptr(), w, n)
    return out


@torch.library.custom_op("pint_tpu_torch::photon_lnlike", mutates_args=(),
                         device_types="cpu")
def _k12_op(frac: torch.Tensor, weights: Optional[torch.Tensor],
            types: torch.Tensor, rows: torch.Tensor, bg: torch.Tensor,
            bins: Optional[torch.Tensor], wrap: bool) -> torch.Tensor:
    return photon_lnlike_plain(frac, weights, types, rows, bg, bins, wrap)


@_k12_op.register_kernel("cuda")
def _(frac, weights, types, rows, bg, bins, wrap):
    return photon_lnlike_cuda(frac, weights, types, rows, bg, bins, wrap)


@_k12_op.register_fake
def _(frac, weights, types, rows, bg, bins, wrap):
    return frac.new_empty((max(frac.shape[0], rows.shape[0]),))


@_k12_op.register_vmap
def _(info, in_dims, frac, weights, types, rows, bg, bins, wrap):
    """One call for the whole batch: each operand's batch dimension in
    front of a logical row count of 1 becomes the walker axis, so
    ``vmap`` over W walkers is one (W, N) launch set."""
    if any(d is not None for d in (in_dims[1], in_dims[2], in_dims[5])):
        raise ValueError("photon_lnlike: weights, types and bins are "
                         "shared by every walker")
    b = info.batch_size

    def rows_of(x, d):
        if d is None:
            return x
        x = x.movedim(d, 0)
        if x.shape[1] != 1:
            raise ValueError("photon_lnlike: under vmap each call takes "
                             "one row of phases and parameters")
        return x.reshape((b,) + x.shape[2:])

    out = _k12_op(rows_of(frac, in_dims[0]), weights, types,
                  rows_of(rows, in_dims[3]), rows_of(bg, in_dims[4]), bins,
                  wrap)
    return out.reshape(b, 1), 0


@torch.library.custom_op("pint_tpu_torch::photon_lnlike_bwd",
                         mutates_args=(), device_types="cpu")
def _k12b_op(frac: torch.Tensor, weights: Optional[torch.Tensor],
             types: torch.Tensor, rows: torch.Tensor, bg: torch.Tensor,
             wrap: bool) -> torch.Tensor:
    return photon_lnlike_bwd_plain(frac, weights, types, rows, bg, wrap)


@_k12b_op.register_kernel("cuda")
def _(frac, weights, types, rows, bg, wrap):
    return photon_lnlike_bwd_cuda(frac, weights, types, rows, bg, wrap)


@_k12b_op.register_fake
def _(frac, weights, types, rows, bg, wrap):
    return frac.new_empty((max(frac.shape[0], rows.shape[0]),
                           1 + K12_ROW * rows.shape[1]))


def _k12_setup(ctx, inputs, output):
    frac, weights, types, rows, bg, bins, wrap = inputs
    ctx.save_for_backward(frac, weights, types, rows, bg)
    ctx.wrap = wrap


def _k12_backward(ctx, gout):
    frac, weights, types, rows, bg = ctx.saved_tensors
    d = _k12b_op(frac, weights, types, rows, bg, ctx.wrap) * gout[:, None]
    w, c = d.shape[0], rows.shape[1]
    g_bg, g_rows = d[:, 0], d[:, 1:].reshape(w, c, K12_ROW)
    if rows.shape[0] == 1 and w > 1:  # one template row for every walker
        g_bg = g_bg.sum(dim=0, keepdim=True)
        g_rows = g_rows.sum(dim=0, keepdim=True)
    return None, None, None, g_rows, g_bg, None, None


_k12_op.register_autograd(_k12_backward, setup_context=_k12_setup)


def photon_lnlike(frac, weights, types, rows, bg, bins=None, wrap=False):
    """lnL (W,) of phases ``frac`` (Wp, N), K12 on CUDA (through the
    custom op: K12b is its backward, ``vmap`` over walkers one launch
    set), the plain version on the CPU.  Arguments as
    :func:`photon_lnlike_plain`.  On the card the phases take no
    gradient."""
    if frac.device.type == "cuda":
        if frac.requires_grad:
            _unported("the gradient of K12 with respect to the phases")
        return _k12_op(frac, weights, types, rows, bg, bins, bool(wrap))
    if frac.device.type != "cpu":
        raise ValueError(f"photon_lnlike: no version for {frac.device}")
    return photon_lnlike_plain(frac, weights, types, rows, bg, bins, wrap)


def photon_density(frac, types, rows, bg, bins=None, wrap=False):
    """f (W, N): K12's density mode on CUDA (one launch), the plain
    version on the CPU."""
    if frac.device.type == "cuda":
        return photon_lnlike_cuda(frac, None, types, rows, bg, bins, wrap,
                                  density=True)
    if frac.device.type != "cpu":
        raise ValueError(f"photon_density: no version for {frac.device}")
    return photon_density_plain(frac, types, rows, bg, bins, wrap)


# --------------------------------------------------------------------------
# the template
# --------------------------------------------------------------------------

class LCTemplate:
    """Mixture of primitives + uniform background (pint_tpu
    templates.py:481).  Parameter vector layout: [norm_1..norm_k,
    prim1_params..., prim2_params...]."""

    def __init__(self, primitives: List, norms=None):
        self.primitives = list(primitives)
        k = len(self.primitives)
        if norms is None:
            norms = [0.5 / k] * k
        self.params = np.array(
            list(norms)
            + [v for p in self.primitives for v in p.init_params()],
            dtype=np.float64)

    @property
    def n_params(self):
        return len(self.params)

    @property
    def k12_ready(self):
        """True when kernel K12 covers every primitive."""
        return all(getattr(p, "k12_type", None) is not None
                   for p in self.primitives)

    def _require_k12(self):
        for prim in self.primitives:
            if getattr(prim, "k12_type", None) is None:
                _unported(f"kernel K12 for {type(prim).__name__}")

    def _split(self, params):
        k = len(self.primitives)
        norms = params[..., :k]
        out = []
        i = k
        for p in self.primitives:
            out.append(params[..., i:i + p.n_params])
            i += p.n_params
        return norms, out

    def _params(self, params, like):
        return _t(self.params if params is None else params, like=like)

    def density(self, phi, params=None, device=None):
        """Normalized profile f(phi) (integrates to 1 over a turn), on
        ``phi``'s device if it is a tensor, else on ``device`` (CUDA
        unless given): K12 on the card."""
        if not isinstance(phi, torch.Tensor):
            phi = torch.as_tensor(np.asarray(phi, np.float64),
                                  device=resolve_device(device))
        phi = phi.to(_F64)
        p = self._params(params, phi)
        if self.k12_ready:
            types, rows, bg = pack_template(self, p)
            shape = phi.shape
            f = photon_density(phi.reshape(1, -1), types, rows[None],
                               bg.reshape(1))
            return f.reshape(shape)
        if phi.device.type == "cuda":
            self._require_k12()
        norms, prim_params = self._split(p)
        out = 1.0 - torch.sum(norms)
        for i, (prim, pp) in enumerate(zip(self.primitives, prim_params)):
            out = out + norms[i] * prim.density(phi, pp)
        return out

    def __call__(self, phi, params=None, device=None):
        return self.density(phi, params, device)

    def lnlike_fn(self, phases, weights=None, device=None):
        """Pure function params -> photon log-likelihood (Kerr 2011
        weighted form), on ``phases``' device if a tensor, else on
        ``device`` (CUDA unless given): K12 and K12b on the card."""
        if not isinstance(phases, torch.Tensor):
            phases = torch.as_tensor(np.asarray(phases, np.float64),
                                     device=resolve_device(device))
        phases = phases.to(_F64)
        w = None if weights is None else _t(weights, like=phases)
        if phases.device.type == "cuda" or self.k12_ready:
            frac = phases.reshape(1, -1)

            def lnlike(params):
                types, rows, bg = pack_template(self, _t(params,
                                                         like=phases))
                return photon_lnlike(frac, w, types, rows[None],
                                     bg.reshape(1))[0]
            return lnlike

        def lnlike_loop(params):
            return torch.sum(photon_log_terms(self.density(phases, params),
                                              w))
        return lnlike_loop


def _norm_barrier(k):
    """Soft barrier keeping sum(norms) <= 1 (pint_tpu templates.py:542):
    1e10 max(sum(p[:k]) - 1, 0)^2 and its gradient, on the host."""

    def value_and_grad(x):
        m = max(float(np.sum(x[:k])) - 1.0, 0.0)
        g = np.zeros(len(x))
        g[:k] = 1e10 * (2.0 * m)
        return 1e10 * m**2, g

    return value_and_grad


class LCFitter:
    """Maximum-likelihood template fitting (pint_tpu templates.py:558):
    scipy's L-BFGS-B on the host, fed -lnL and its gradient from the
    device (K12 and K12b on the card), on ``device`` (CUDA unless
    given)."""

    def __init__(self, template: LCTemplate, phases, weights=None,
                 device=None):
        self.template = template
        self.device = resolve_device(device)
        self.phases = np.asarray(phases, dtype=np.float64) % 1.0
        self.weights = weights
        self._phases_t = torch.as_tensor(self.phases, device=self.device)
        self._lnlike = template.lnlike_fn(self._phases_t, weights)
        self.nit = None

    def lnlike(self, params=None):
        p = self.template.params if params is None else params
        with torch.no_grad():
            return float(self._lnlike(_t(p, device=self.device)))

    def _val_grad(self, x):
        """(-lnL, its gradient) at ``x`` (numpy), on the device."""
        p = torch.as_tensor(np.asarray(x, np.float64),
                            device=self.device).requires_grad_(True)
        v = -self._lnlike(p)
        (g,) = torch.autograd.grad(v, p)
        return v.detach(), g

    def fit(self, maxiter=200):
        """L-BFGS-B with bounds keeping norms and widths physical;
        returns (params, lnlike) and updates the template in place.  The
        iteration count lands in ``nit``."""
        from scipy.optimize import minimize

        k = len(self.template.primitives)
        x0 = np.array(self.template.params)
        bounds = [(1e-4, 1.0)] * k
        for p in self.template.primitives:
            bounds += p.param_bounds()
        barrier = _norm_barrier(k)

        def fun(x):
            v, g = self._val_grad(x)
            vb, gb = barrier(x)
            return float(v) + vb, g.cpu().numpy().astype(np.float64) + gb

        res = minimize(fun, x0, jac=True, method="L-BFGS-B",
                       bounds=bounds, options={"maxiter": maxiter})
        self.nit = int(res.nit)
        self.template.params = np.asarray(res.x)
        i = k
        for p in self.template.primitives:
            self.template.params[i + p.loc_index] %= 1.0
            i += p.n_params
        return self.template.params, -float(res.fun)

    def param_uncertainties(self):
        """1-sigma uncertainties from the inverse Hessian of -lnL: the
        Hessian by ``torch.func.hessian`` of the plain version on the
        CPU.  On the card it would need a double backward of K12b, which
        is not written: it raises."""
        if self.device.type != "cpu":
            _unported("LCFitter.param_uncertainties on the card (a double "
                      "backward of kernel K12b)")
        x = torch.as_tensor(np.asarray(self.template.params, np.float64))
        H = torch.func.hessian(lambda p: -self._lnlike(p))(x).numpy()
        try:
            cov = np.linalg.inv(H)
            return np.sqrt(np.clip(np.diag(cov), 0, None))
        except np.linalg.LinAlgError:
            return np.full(self.template.n_params, np.nan)


# --------------------------------------------------------------------------
# energy-dependent templates: not ported
# --------------------------------------------------------------------------

class LCEWrapped:
    """Energy-dependent primitive (pint_tpu templates.py:624): not
    ported; its per-photon parameters need another kernel shape."""

    def __init__(self, *args, **kwargs):
        _unported(f"{type(self).__name__} (energy-dependent templates)")


class LCEGaussian(LCEWrapped):
    pass


class LCESkewGaussian(LCEWrapped):
    pass


class LCELorentzian(LCEWrapped):
    pass


class LCELorentzian2(LCEWrapped):
    pass


class LCEGaussian2(LCEWrapped):
    pass


class LCEVonMises(LCEWrapped):
    pass


class ENormAngles(LCEWrapped):
    pass


class LCETemplate(LCEWrapped):
    pass


class LCEFitter(LCEWrapped):
    pass


# --------------------------------------------------------------------------
# template file I/O (pint_tpu templates.py:849-961)
# --------------------------------------------------------------------------

def _fwhm_loc(kind, width_param, loc):
    """(FWHM, loc) of a peaked primitive from its width parameter."""
    if kind is LCGaussian:
        return _FWHM_SIGMA * width_param, loc
    if kind is LCLorentzian:
        return 2.0 * width_param, loc
    if kind is LCVonMises:
        return (np.arccos(max(1.0 - np.log(2.0) / width_param, -1.0))
                / np.pi, loc)
    raise ValueError(
        f"need a gaussian-like peaked primitive, not {kind.__name__}")


def prof_string(template: LCTemplate) -> str:
    """pygaussfit-compatible text for a gaussian-mixture template."""
    norms, prim_params = template._split(np.asarray(template.params))
    lines = []
    total = 0.0
    for i, (prim, pp) in enumerate(zip(template.primitives, prim_params),
                                   start=1):
        width, loc = _fwhm_loc(type(prim), pp[0], pp[1])
        ampl = float(norms[i - 1])
        total += ampl
        lines += [f"phas{i} = {loc % 1.0:.5f} +/- 0.00000",
                  f"fwhm{i} = {width:.5f} +/- 0.00000",
                  f"ampl{i} = {ampl:.5f} +/- 0.00000"]
    dashes = "-" * 25
    return "\n".join([dashes, f"const = {1.0 - total:.5f} +/- 0.00000"]
                     + lines + [dashes])


def write_template(template: LCTemplate, path):
    """Write a ``# gauss`` template file readable by read_template."""
    with open(path, "w") as f:
        f.write("# gauss\n")
        f.write(prof_string(template) + "\n")


def read_template(path) -> LCTemplate:
    """Read a template file: header ``gauss`` (phas/fwhm/ampl rows),
    ``fourier`` (alpha beta rows) or ``kernel`` (photon phases)."""
    with open(path, "r") as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if not lines:
        raise ValueError(f"empty template file {path}")
    label, body = lines[0].lower(), lines[1:]
    toks = [ln.split() for ln in body]
    if "gauss" in label:
        locs, fwhms, ampls = {}, {}, {}
        for tok in toks:
            if not tok or "=" not in tok:
                continue
            key, val = tok[0].lower(), float(tok[2])
            if key.startswith("phas"):
                locs[int(key[4:] or 1)] = val
            elif key.startswith("fwhm"):
                fwhms[int(key[4:] or 1)] = val
            elif key.startswith("ampl"):
                ampls[int(key[4:] or 1)] = val
        if not fwhms or sorted(fwhms) != sorted(locs) \
                or sorted(fwhms) != sorted(ampls):
            raise ValueError(
                f"unbalanced gauss template in {path}: peaks "
                f"{sorted(locs)} / widths {sorted(fwhms)} / "
                f"amplitudes {sorted(ampls)}")
        idx = sorted(fwhms)
        prims = [LCGaussian(sigma=fwhms[i] / _FWHM_SIGMA, loc=locs[i])
                 for i in idx]
        return LCTemplate(prims, norms=[ampls[i] for i in idx])
    if "fourier" in label:
        return LCTemplate([LCEmpiricalFourier(input_file=path)],
                          norms=[1.0])
    if "kernel" in label:
        phases = [float(t[0]) for t in toks if t]
        return LCTemplate([LCKernelDensity(phases=phases)], norms=[1.0])
    raise ValueError(f"unrecognized template format header {label!r}")


def read_gaussfitfile(path, proflen, device=None):
    """Binned profile (length ``proflen``) from a pygaussfit output file,
    evaluated on ``device`` (CUDA unless given), as numpy."""
    tmpl = read_template(path)
    grid = (np.arange(proflen) + 0.5) / proflen
    return tmpl.density(grid, device=device).cpu().numpy()


def convert_primitive(prim, ptype=LCLorentzian):
    """Convert one peak to another kind, keeping location and FWHM."""
    if type(prim) not in (LCGaussian, LCLorentzian, LCVonMises):
        raise ValueError(f"cannot convert {type(prim).__name__}")
    fwhm, loc = _fwhm_loc(type(prim), prim.init_params()[0], prim.loc)
    if ptype is LCGaussian:
        return LCGaussian(sigma=fwhm / _FWHM_SIGMA, loc=loc)
    if ptype is LCLorentzian:
        return LCLorentzian(gamma=fwhm / 2.0, loc=loc)
    if ptype is LCVonMises:
        half = np.cos(np.pi * fwhm)
        return LCVonMises(kappa=np.log(2.0) / max(1.0 - half, 1e-12),
                          loc=loc)
    raise ValueError(f"cannot convert to {ptype}")
