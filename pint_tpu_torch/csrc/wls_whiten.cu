// Kernel K7: the whitening pass of the WLS Gauss-Newton step.
//
// Replaces pint_tpu/fitter.py:152-158 inside wls_gn_solve:
//
//   w = 1 / err;  rw = r * w;  Jw = J * w[:, None]
//   norms = sqrt(sum_i Jw[i, :]^2), zeros replaced by 1
//   Jn = Jw / norms;  chi2 = sum_i rw[i]^2
//
// r (N,), J (N, P) row-major and err (N,) in; rw (N,), Jn (N, P),
// norms (P,) and chi2 (a 1-element tensor) out, all float64.  The SVD
// that follows stays a library call.
//
// Why by hand: the column sums over N must come out the same on every
// run; torch.sum on CUDA does not promise a reduction order.  Here the
// order is fixed by construction, as in K2 and K3:
//
//   pass 1 (wls_whiten_partial): one block per split of
//     rows_per_block consecutive rows.  Thread t adds, in ascending row
//     order, the squares of rows t, t + 256, ... of its split for one
//     column at a time (column P is rw); the 256 sums are then reduced
//     in shared memory by a fixed halving tree, and thread 0 writes the
//     split's partial.
//   pass 2 (wls_whiten_apply): every block sums the partials of each
//     column in ascending split order into shared memory (the same
//     order in every block, so every block holds the same bits), takes
//     the square root and replaces a zero by 1; block 0 writes norms and
//     chi2.  Then each thread writes rw and the P entries of Jn for its
//     rows (grid-stride).
//
// rw and Jn use the plain version's operations in its order (one
// correctly rounded multiply, one division), so for equal norms they are
// bit-identical to it; the norms and chi2 differ from torch.sum's only
// by summation order.  -fmad=false keeps every product separately
// rounded.  Row offsets are int64 products; no loop divides an integer
// (the launcher alone sizes the splits).
//
// Bound on an H100 (3.35 TB/s): memory.  J, r and err are read once and
// Jn, rw written once: 8 (2 N P + 3 N) bytes, ~1.9 MB at N = 10^4,
// P = 11, ~0.6 us; two launches' latency is the real cost.

#include <cstdint>
#include <cuda_runtime.h>

#define K7_THREADS 256

__global__ void __launch_bounds__(K7_THREADS)
wls_whiten_partial(const double* __restrict__ r,
                   const double* __restrict__ J,
                   const double* __restrict__ err,
                   double* __restrict__ partial, int64_t n, int64_t p,
                   int64_t rows_per_block) {
  __shared__ double sh[K7_THREADS];
  const int t = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * rows_per_block;
  int64_t row1 = row0 + rows_per_block;
  if (row1 > n) row1 = n;
  for (int64_t c = 0; c <= p; ++c) {
    double acc = 0.0;
    for (int64_t i = row0 + t; i < row1; i += K7_THREADS) {
      const double w = 1.0 / err[i];
      const double v = (c < p) ? J[i * p + c] * w : r[i] * w;
      acc = __dadd_rn(acc, __dmul_rn(v, v));
    }
    sh[t] = acc;
    __syncthreads();
    for (int s = K7_THREADS / 2; s > 0; s >>= 1) {
      if (t < s) sh[t] = __dadd_rn(sh[t], sh[t + s]);
      __syncthreads();
    }
    if (t == 0) partial[(int64_t)blockIdx.x * (p + 1) + c] = sh[0];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(K7_THREADS)
wls_whiten_apply(const double* __restrict__ r, const double* __restrict__ J,
                 const double* __restrict__ err,
                 const double* __restrict__ partial,
                 double* __restrict__ rw, double* __restrict__ jn,
                 double* __restrict__ norms, double* __restrict__ chi2,
                 int64_t n, int64_t p, int64_t splits) {
  extern __shared__ double col[];  // p + 1 entries
  for (int64_t c = threadIdx.x; c <= p; c += K7_THREADS) {
    double acc = 0.0;
    for (int64_t s = 0; s < splits; ++s)
      acc = __dadd_rn(acc, partial[s * (p + 1) + c]);
    if (c < p) {
      const double nrm = sqrt(acc);
      col[c] = (nrm == 0.0) ? 1.0 : nrm;
      if (blockIdx.x == 0) norms[c] = col[c];
    } else if (blockIdx.x == 0) {
      chi2[0] = acc;
    }
  }
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * K7_THREADS;
  for (int64_t i = (int64_t)blockIdx.x * K7_THREADS + threadIdx.x; i < n;
       i += stride) {
    const double w = 1.0 / err[i];
    rw[i] = r[i] * w;
    const int64_t base = i * p;
    for (int64_t c = 0; c < p; ++c) {
      const double jw = J[base + c] * w;
      jn[base + c] = jw / col[c];
    }
  }
}

// Rows per split: whole 256-row passes, at most 1024 splits.
static int64_t rows_per_split(int64_t n) {
  const int64_t cap = (int64_t)K7_THREADS * 1024;
  const int64_t passes = (n + cap - 1) / cap;
  return K7_THREADS * (passes > 0 ? passes : 1);
}

extern "C" int wls_whiten_splits(int64_t n) {
  const int64_t rows = rows_per_split(n);
  return (int)((n + rows - 1) / rows);
}

extern "C" int wls_whiten_launch(const void* r, const void* J,
                                 const void* err, void* partial, void* rw,
                                 void* jn, void* norms, void* chi2,
                                 int64_t n, int64_t p, void* stream) {
  if (n <= 0 || p < 0) return (int)cudaErrorInvalidValue;
  const int64_t rows = rows_per_split(n);
  const int64_t splits = (n + rows - 1) / rows;
  cudaStream_t st = (cudaStream_t)stream;
  wls_whiten_partial<<<(unsigned)splits, K7_THREADS, 0, st>>>(
      (const double*)r, (const double*)J, (const double*)err,
      (double*)partial, n, p, rows);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  int64_t blocks = (n + K7_THREADS - 1) / K7_THREADS;
  if (blocks > 528) blocks = 528;  // 4 per SM on 132 SMs; grid-stride
  wls_whiten_apply<<<(unsigned)blocks, K7_THREADS,
                     (size_t)(p + 1) * sizeof(double), st>>>(
      (const double*)r, (const double*)J, (const double*)err,
      (const double*)partial, (double*)rw, (double*)jn, (double*)norms,
      (double*)chi2, n, p, splits);
  return (int)cudaGetLastError();
}
