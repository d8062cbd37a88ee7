// Kernel K1: exact fixed-point pulse phase F0 * t.
//
// Replaces pint_tpu/fixedpoint.py:110 phase_f0_t_raw (with
// :77 mul_64x64_128) and the NaN-poison guard of :128 phase_f0_t.  On
// the TPU the 128-bit product was emulated with 32-bit limbs in uint64;
// here the hardware gives the high half directly (__mul64hi) and the
// low half is the wrapped 64-bit product.
//
// Per output element i of a (rows, cols) array, r = i / cols and
// c = i - r * cols:
//   f0     = f0p[r * f0_rs + c * f0_cs],  t = tp[r * t_rs + c * t_cs]
//   f0_fix = round_half_even(f0 * 2^52)              (int64, 2^-52 Hz)
//   P      = f0_fix * t  as signed 128 bits           (2^-84 turns)
//   n      = P >> 84 = hi >> 20                        (integer turns)
//   frac   = bits 20..83 of P as uint64, * 2^-64       (float64)
//   frac >= 0.5 carries one turn into n.
//   Poison: !isfinite(f0*t*2^-32), |f0*t*2^-32| >= 2^43, f0 <= 0 or
//   f0 >= 2048 give n = 0, frac = NaN.
// The strides (in elements, 0 along a broadcast dimension) let one
// launch take one F0 for all TOAs (the fit), one F0 per TOA, or G grid
// points' F0 values against one tick array (rows = G, cols = N, f0
// strides (1, 0), tick strides (0, 1)): a batch of points costs one
// launch and no copy of F0 or of the ticks.
// Built with -fmad=false: the guard's product and the fraction's
// scaling must round exactly as the plain PyTorch version does.
//
// Bound on an H100 (3.35 TB/s): memory.  Each output reads 8 B of ticks
// and writes 8 B of n and 8 B of frac, 24 B; at N = 10^4 that is
// 240 KB, about 0.07 us, so a launch of the fit's size is dominated by
// launch latency; at a 256-point grid (2.56e6 outputs, the ticks read
// from L2) the writes, 41 MB, ~12 us.  The design meets the bound with
// one thread per output, neighbouring threads on neighbouring 8-byte
// words (coalesced), F0 read through a device pointer (an L1/L2
// broadcast) — never copied to the host, so a phase evaluation costs no
// host sync.

#include <cstdint>
#include <cuda_runtime.h>

__global__ void phase_f0_t_kernel(const double* __restrict__ f0p,
                                  const int64_t* __restrict__ tp,
                                  int64_t* __restrict__ n_out,
                                  double* __restrict__ frac_out,
                                  int64_t rows, int64_t cols, int64_t f0_rs,
                                  int64_t f0_cs, int64_t t_rs,
                                  int64_t t_cs) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * cols) return;
  const int64_t r = i / cols;
  const int64_t c = i - r * cols;
  const double f0 = f0p[r * f0_rs + c * f0_cs];
  const int64_t ti = tp[r * t_rs + c * t_cs];
  const int64_t f0_fix = __double2ll_rn(__dmul_rn(f0, 0x1p52));
  const int64_t hi = __mul64hi(f0_fix, ti);
  const uint64_t lo = (uint64_t)f0_fix * (uint64_t)ti;
  int64_t n = hi >> 20;
  const uint64_t bits = ((uint64_t)hi << 44) | (lo >> 20);
  double frac = __dmul_rn(__ull2double_rn(bits), 0x1p-64);
  if (frac >= 0.5) {
    n += 1;
    frac = __dsub_rn(frac, 1.0);
  }
  const double secs = __dmul_rn(__ll2double_rn(ti), 0x1p-32);
  const double expect = __dmul_rn(f0, secs);
  const bool bad = !isfinite(expect) || fabs(expect) >= 0x1p43 ||
                   f0 <= 0.0 || f0 >= 2048.0;
  n_out[i] = bad ? 0 : n;
  frac_out[i] = bad ? __longlong_as_double(0x7ff8000000000000LL) : frac;
}

extern "C" int phase_f0_t_launch(const void* f0, const void* t, void* n_out,
                                 void* frac_out, int64_t rows, int64_t cols,
                                 int64_t f0_rs, int64_t f0_cs, int64_t t_rs,
                                 int64_t t_cs, void* stream) {
  if (rows < 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t count = rows * cols;
  const int64_t blocks = (count + threads - 1) / threads;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  phase_f0_t_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const double*)f0, (const int64_t*)t, (int64_t*)n_out,
      (double*)frac_out, rows, cols, f0_rs, f0_cs, t_rs, t_cs);
  return (int)cudaGetLastError();
}
