// Kernel K1: exact fixed-point pulse phase F0 * t.
//
// Replaces pint_tpu/fixedpoint.py:110 phase_f0_t_raw (with
// :77 mul_64x64_128) and the NaN-poison guard of :128 phase_f0_t.  On
// the TPU the 128-bit product was emulated with 32-bit limbs in uint64;
// here the hardware gives the high half directly (__mul64hi) and the
// low half is the wrapped 64-bit product.
//
// Per TOA i:
//   f0_fix = round_half_even(f0 * 2^52)              (int64, 2^-52 Hz)
//   P      = f0_fix * t[i]  as signed 128 bits        (2^-84 turns)
//   n      = P >> 84 = hi >> 20                        (integer turns)
//   frac   = bits 20..83 of P as uint64, * 2^-64       (float64)
//   frac >= 0.5 carries one turn into n.
//   Poison: !isfinite(f0*t*2^-32), |f0*t*2^-32| >= 2^43, f0 <= 0 or
//   f0 >= 2048 give n = 0, frac = NaN.
// Built with -fmad=false: the guard's product and the fraction's
// scaling must round exactly as the plain PyTorch version does.
//
// Bound on an H100 (3.35 TB/s): memory.  Each TOA reads 8 B of ticks
// and writes 8 B of n and 8 B of frac, 24 B; at N = 10^4 that is
// 240 KB, about 0.07 us, so a launch of the fit's size is dominated by
// launch latency.  The design meets the bound with one thread per TOA,
// neighbouring threads on neighbouring 8-byte words (coalesced), F0
// read once per thread from device memory (an L1/L2 broadcast) — never
// copied to the host, so a phase evaluation costs no host sync.  F0 is
// one value for all TOAs (f0_stride 0, the fit's case) or one per TOA
// (f0_stride 1, used to check many frequencies in one launch).

#include <cstdint>
#include <cuda_runtime.h>

__global__ void phase_f0_t_kernel(const double* __restrict__ f0p,
                                  const int64_t* __restrict__ t,
                                  int64_t* __restrict__ n_out,
                                  double* __restrict__ frac_out,
                                  int64_t count, int64_t f0_stride) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const double f0 = f0p[i * f0_stride];
  const int64_t ti = t[i];
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
                                 void* frac_out, int64_t count,
                                 int64_t f0_stride, void* stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((count + threads - 1) / threads);
  phase_f0_t_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const double*)f0, (const int64_t*)t, (int64_t*)n_out,
      (double*)frac_out, count, f0_stride);
  return (int)cudaGetLastError();
}
