"""Exact fixed-point phase F0 * t, the port of ``pint_tpu.fixedpoint``.

The giant term of pulsar phase, F0 * (t - PEPOCH) ~ 4e11 turns needed
to ~1e-6 turns, is carried as an exact signed 64x64 -> 128-bit product
of F0 in units of 2^-52 Hz and t in int64 ticks of 2^-32 s, split into
(int64 integer turns, float64 fraction in [-0.5, 0.5)).  Every smaller
term stays in float64.

Two implementations of one function, chosen by the device of the
tensors they are given:

- CUDA: kernel K1, ``csrc/phase_f0_t.cu`` — one thread per TOA, the
  128-bit product from ``__mul64hi`` and the wrapped low half, F0 read
  through a device pointer so a phase evaluation costs no host sync.
- CPU: the plain PyTorch version below.  PyTorch has no shifts, adds or
  compares on uint64, so the 32-bit-limb schoolbook product runs in
  int64 with explicit masks after every arithmetic shift (int64 ``*``
  and ``+`` wrap mod 2^64, which is all the limb algebra needs), and
  the unsigned 64-bit fraction converts to float64 as
  ``hi32 * 2^32 + lo32`` — one correctly rounded add, bit-identical to
  a correctly rounded uint64 -> float64 conversion.

Both give bit-identical ``(n, frac)``, including the NaN-poison branch.

Differentiation: :func:`phase_f0_t` is a ``torch.autograd.Function``
whose forward-mode ``jvp`` is the analytic tangent t * dF0, so
``torch.func.jacfwd`` composes through the integer path.  The kernel
itself is registered as the custom op ``pint_tpu_torch::phase_f0_t``
so it dispatches cleanly under the function transforms, with a batching
rule: under ``torch.func.vmap`` over G points (a chi^2 grid over F0,
say) the op runs once on the whole batch, one K1 launch over G x N,
never once per point.
"""

from __future__ import annotations

import ctypes

import torch

from pint_tpu_torch._cuda import CudaKernel

TICKS_PER_SEC = float(2**32)  #: time resolution: 2^-32 s per tick
FREQ_SCALE = float(2**52)  #: frequency resolution: 2^-52 Hz per unit

_MASK32 = 0xFFFFFFFF
_TWO32_I = 1 << 32
_TWO44_I = 1 << 44

#: kernel K1 (replaces pint_tpu/fixedpoint.py:110 phase_f0_t_raw and
#: :128 phase_f0_t's guard)
K1 = CudaKernel(
    "phase_f0_t", "phase_f0_t.cu", "phase_f0_t_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6)


def ticks_to_seconds(ticks):
    """int64 ticks to float64 seconds."""
    return ticks.to(torch.float64) * (1.0 / TICKS_PER_SEC)


def freq_to_fix(f0):
    """Round a float64 frequency (Hz) to int64 units of 2^-52 Hz
    (round half to even, as ``jnp.round``)."""
    return torch.round(f0.to(torch.float64) * FREQ_SCALE).to(torch.int64)


def _lsr(x, k):
    """Logical right shift of int64 bits: arithmetic shift, then mask
    off the copied sign bits."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def mul_64x64_128(a, b):
    """Exact signed 64x64 -> 128-bit product as (hi: int64, lo: int64
    holding the low 64 bits).  Schoolbook over 32-bit limbs; every
    partial product and add wraps mod 2^64.  Signedness via
    a_s * b_s = a_u * b_u - 2^64 ((a<0) b_u + (b<0) a_u)."""
    a0 = a & _MASK32
    a1 = _lsr(a, 32)
    b0 = b & _MASK32
    b1 = _lsr(b, 32)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = _lsr(p00, 32) + (p01 & _MASK32) + (p10 & _MASK32)
    lo = (p00 & _MASK32) | ((mid & _MASK32) * _TWO32_I)
    hi_u = p11 + _lsr(p01, 32) + _lsr(p10, 32) + _lsr(mid, 32)
    zero = torch.zeros((), dtype=torch.int64, device=a.device)
    corr = torch.where(a < 0, b, zero) + torch.where(b < 0, a, zero)
    return hi_u - corr, lo


def _u64_to_f64(bits):
    """Correctly rounded float64 of the unsigned value of int64 bits."""
    hi = _lsr(bits, 32).to(torch.float64)
    lo = (bits & _MASK32).to(torch.float64)
    return hi * 4294967296.0 + lo


def phase_f0_t_raw(f0_fix, t_ticks):
    """Exact F0*t: (integer turns int64, fraction float64 in
    [-0.5, 0.5)).  The product is in units of 2^-84 turns; integer turns
    are ``hi >> 20`` and the fraction is bits 20..83 over 2^64."""
    hi, lo = mul_64x64_128(f0_fix, t_ticks)
    n = hi >> 20
    frac_bits = (hi * _TWO44_I) | _lsr(lo, 20)
    frac = _u64_to_f64(frac_bits) * (1.0 / float(2**64))
    carry = frac >= 0.5
    n = torch.where(carry, n + 1, n)
    frac = torch.where(carry, frac - 1.0, frac)
    return n, frac


def phase_f0_t_plain(f0, t_ticks):
    """The plain PyTorch version of kernel K1: exact F0*t with the
    NaN-poison range guard.  ``f0`` float64 (Hz) and ``t_ticks`` int64
    ticks broadcast against each other (a 0-d F0 for the fit, one F0
    per TOA, or F0 of shape (G, 1) against (N,) ticks for G points)."""
    n, frac = phase_f0_t_raw(freq_to_fix(f0), t_ticks)
    expect = f0 * ticks_to_seconds(t_ticks)
    bad = (
        ~torch.isfinite(expect)
        | (torch.abs(expect) >= float(2**43))
        | (f0 <= 0.0)
        | (f0 >= 2048.0)
    )
    return (torch.where(bad, torch.zeros_like(n), n),
            torch.where(bad, torch.full_like(frac, float("nan")), frac))


def _rows_cols(x, shape, rows, cols):
    """``x`` broadcast to ``shape`` and seen as (rows, cols): the view
    (stride 0 along broadcast dimensions) and its two strides."""
    x2 = x.expand(shape).reshape(rows, cols)
    return x2, x2.stride(0), x2.stride(1)


def phase_f0_t_cuda(f0, t_ticks):
    """Kernel K1 on CUDA tensors, ``f0`` and ``t_ticks`` broadcast as in
    :func:`phase_f0_t_plain`.  The output is seen as (rows, cols) with
    cols its last dimension; each operand reaches the kernel as a
    pointer and two strides, so a broadcast F0 or tick array is never
    copied.  Checks device and dtype, allocates the outputs and
    launches once; raises on anything the kernel does not take."""
    if f0.device.type != "cuda" or t_ticks.device != f0.device:
        raise ValueError("phase_f0_t_cuda: f0 and t_ticks must be on one "
                         "CUDA device")
    if f0.dtype != torch.float64:
        raise ValueError("phase_f0_t_cuda: f0 must be float64")
    if t_ticks.dtype != torch.int64:
        raise ValueError("phase_f0_t_cuda: t_ticks must be int64")
    shape = torch.broadcast_shapes(f0.shape, t_ticks.shape)
    n = torch.empty(shape, dtype=torch.int64, device=f0.device)
    frac = torch.empty(shape, dtype=torch.float64, device=f0.device)
    if n.numel():
        cols = shape[-1] if len(shape) else 1
        rows = n.numel() // cols
        f2, f_rs, f_cs = _rows_cols(f0, shape, rows, cols)
        t2, t_rs, t_cs = _rows_cols(t_ticks, shape, rows, cols)
        K1.launch(f0.device, f2.data_ptr(), t2.data_ptr(), n.data_ptr(),
                  frac.data_ptr(), rows, cols, f_rs, f_cs, t_rs, t_cs)
    return n, frac


@torch.library.custom_op("pint_tpu_torch::phase_f0_t", mutates_args=(),
                         device_types="cpu")
def _phase_f0_t_op(f0: torch.Tensor, t_ticks: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    return phase_f0_t_plain(f0, t_ticks)


@_phase_f0_t_op.register_kernel("cuda")
def _(f0, t_ticks):
    return phase_f0_t_cuda(f0, t_ticks)


@_phase_f0_t_op.register_fake
def _(f0, t_ticks):
    shape = torch.broadcast_shapes(f0.shape, t_ticks.shape)
    return (t_ticks.new_empty(shape),
            torch.empty(shape, dtype=torch.float64, device=t_ticks.device))


@_phase_f0_t_op.register_vmap
def _(info, in_dims, f0, t_ticks):
    """One call for the whole batch: each batched operand gets its batch
    dimension in front and ones before its own dimensions, so a batch of
    F0 values (G,) against unbatched ticks (N,) is one (G, N) launch."""
    nd = max(x.dim() - (d is not None)
             for x, d in zip((f0, t_ticks), in_dims))

    def lift(x, d):
        if d is None:
            return x
        x = x.movedim(d, 0)
        return x.reshape(x.shape[:1] + (1,) * (nd + 1 - x.dim())
                         + x.shape[1:])

    return (_phase_f0_t_op(lift(f0, in_dims[0]), lift(t_ticks, in_dims[1])),
            (0, 0))


class _PhaseF0T(torch.autograd.Function):
    """phase_f0_t with the analytic forward-mode tangent t * dF0 (the
    counterpart of pint_tpu's ``custom_jvp``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(f0, t_ticks):
        return _phase_f0_t_op(f0, t_ticks)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, t_ticks = inputs
        ctx.save_for_forward(t_ticks)
        ctx.mark_non_differentiable(output[0])

    @staticmethod
    def jvp(ctx, df0, _dt):
        (t_ticks,) = ctx.saved_tensors
        return None, ticks_to_seconds(t_ticks) * df0


def phase_f0_t(f0, t_ticks):
    """Exact pulse phase F0*t, differentiable in F0 (forward mode).

    f0: float64 tensor, Hz (quantized to 2^-52 Hz), 0-d or broadcast
    against t_ticks: int64 ticks since the reference epoch.  Returns (n
    int64 turns, frac float64 in [-0.5, 0.5)).  Out-of-range inputs
    (f0 <= 0, f0 >= 2048 Hz, |F0*t| >= 2^43 turns, non-finite) give
    n = 0, frac = NaN instead of a wrapped, plausible-looking phase."""
    return _PhaseF0T.apply(f0, t_ticks)


def renorm_phase(n, frac):
    """Re-center (n, frac) after float64 terms were added to frac, so
    frac is back in [-0.5, 0.5).  floor(frac + 0.5), not round(): half
    to even would leave frac == +0.5."""
    shift = torch.floor(frac + 0.5)
    return n + shift.to(torch.int64), frac - shift
