// Kernel K7: the whitening pass of the WLS Gauss-Newton step, for one
// design or a batch of G designs (the points of a chi^2 grid).
//
// Replaces pint_tpu/fitter.py:152-158 inside wls_gn_solve:
//
//   w = 1 / err;  rw = r * w;  Jw = J * w[:, None]
//   norms = sqrt(sum_i Jw[i, :]^2), zeros replaced by 1
//   Jn = Jw / norms;  chi2 = sum_i rw[i]^2
//
// Per point g: r (N,), J (N, P) row-major and err (N,) in (err shared
// by every point, err_stride 0, or one row per point, err_stride N);
// rw (N,), Jn (N, P), norms (P,) and chi2 out, all float64, the points
// stacked in front.  The SVD that follows stays a library call.
//
// Why by hand: the column sums over N must come out the same on every
// run; torch.sum on CUDA does not promise a reduction order.  Here the
// order is fixed by construction, as in K2 and K3:
//
//   pass 1 (wls_whiten_partial): one block per (split of rows_per_block
//     consecutive rows, point).  Thread t takes rows t, t + 256, ... of
//     its split in ascending order, reads each row of J (and err, r)
//     once and keeps the squares of up to 32 columns in registers (the
//     columns come in chunks of 32; column P is rw, so a design of up
//     to 31 parameters is one chunk and every row is read once).  Each
//     column's 256 sums are then reduced by a fixed butterfly inside
//     each warp (lane 0's sum is kept) and the 8 warp sums are added in
//     ascending warp order; one thread per column writes the split's
//     partial.
//   pass 2 (wls_whiten_apply): every block of point g sums g's partials
//     of each column in ascending split order into shared memory (the
//     same order in every block, so every block holds the same bits),
//     takes the square root and replaces a zero by 1; block 0 writes
//     norms and chi2.  Then each thread writes rw and the P entries of
//     Jn for its rows (grid-stride).
//
// rw and Jn use the plain version's operations in its order (one
// correctly rounded multiply, one division), so for equal norms they are
// bit-identical to it; the norms and chi2 differ from torch.sum's only
// by summation order.  -fmad=false keeps every product separately
// rounded.  Row offsets are int64 products; no loop divides an integer
// (the launcher alone sizes the splits).
//
// Bound on an H100 (3.35 TB/s): memory.  J, r and err are read once and
// Jn, rw written once: 8 G (2 N P + 2 N) + 8 N bytes, ~1.9 MB at one
// point of N = 10^4, P = 11 (~0.6 us, so two launches' latency is the
// real cost), ~290 MB at a 256-point grid of P = 8 (~87 us).

#include <cstdint>
#include <cuda_runtime.h>

#define K7_THREADS 256
#define K7_WARPS (K7_THREADS / 32)
#define K7_CHUNK 32

__global__ void __launch_bounds__(K7_THREADS)
wls_whiten_partial(const double* __restrict__ r,
                   const double* __restrict__ J,
                   const double* __restrict__ err,
                   double* __restrict__ partial, int64_t n, int64_t p,
                   int64_t err_stride, int64_t rows_per_block) {
  __shared__ double sh[K7_WARPS][K7_CHUNK];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t g = blockIdx.y;
  const int64_t splits = gridDim.x;
  const double* rg = r + g * n;
  const double* Jg = J + g * n * p;
  const double* eg = err + g * err_stride;
  const int64_t row0 = (int64_t)blockIdx.x * rows_per_block;
  int64_t row1 = row0 + rows_per_block;
  if (row1 > n) row1 = n;
  for (int64_t c0 = 0; c0 <= p; c0 += K7_CHUNK) {
    double acc[K7_CHUNK];
#pragma unroll
    for (int j = 0; j < K7_CHUNK; ++j) acc[j] = 0.0;
    for (int64_t i = row0 + t; i < row1; i += K7_THREADS) {
      const double w = 1.0 / eg[i];
      const double* Ji = Jg + i * p;
#pragma unroll
      for (int j = 0; j < K7_CHUNK; ++j) {
        const int64_t c = c0 + j;
        if (c <= p) {
          const double v = (c < p) ? Ji[c] * w : rg[i] * w;
          acc[j] = __dadd_rn(acc[j], __dmul_rn(v, v));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < K7_CHUNK; ++j) {
      double v = acc[j];
      for (int off = 16; off > 0; off >>= 1)
        v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == 0) sh[warp][j] = v;
    }
    __syncthreads();
    if (t < K7_CHUNK && c0 + t <= p) {
      double s = 0.0;
      for (int wi = 0; wi < K7_WARPS; ++wi) s = __dadd_rn(s, sh[wi][t]);
      partial[(g * splits + blockIdx.x) * (p + 1) + c0 + t] = s;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(K7_THREADS)
wls_whiten_apply(const double* __restrict__ r, const double* __restrict__ J,
                 const double* __restrict__ err,
                 const double* __restrict__ partial,
                 double* __restrict__ rw, double* __restrict__ jn,
                 double* __restrict__ norms, double* __restrict__ chi2,
                 int64_t n, int64_t p, int64_t err_stride, int64_t splits) {
  extern __shared__ double col[];  // p + 1 entries
  const int64_t g = blockIdx.y;
  const double* pg = partial + g * splits * (p + 1);
  for (int64_t c = threadIdx.x; c <= p; c += K7_THREADS) {
    double acc = 0.0;
    for (int64_t s = 0; s < splits; ++s)
      acc = __dadd_rn(acc, pg[s * (p + 1) + c]);
    if (c < p) {
      const double nrm = sqrt(acc);
      col[c] = (nrm == 0.0) ? 1.0 : nrm;
      if (blockIdx.x == 0) norms[g * p + c] = col[c];
    } else if (blockIdx.x == 0) {
      chi2[g] = acc;
    }
  }
  __syncthreads();
  const double* rg = r + g * n;
  const double* Jg = J + g * n * p;
  const double* eg = err + g * err_stride;
  const int64_t stride = (int64_t)gridDim.x * K7_THREADS;
  for (int64_t i = (int64_t)blockIdx.x * K7_THREADS + threadIdx.x; i < n;
       i += stride) {
    const double w = 1.0 / eg[i];
    rw[g * n + i] = rg[i] * w;
    const int64_t base = i * p;
    for (int64_t c = 0; c < p; ++c) {
      const double jw = Jg[base + c] * w;
      jn[g * n * p + base + c] = jw / col[c];
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
                                 int64_t g, int64_t n, int64_t p,
                                 int64_t err_stride, void* stream) {
  if (g <= 0 || g > 65535 || n <= 0 || p < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t rows = rows_per_split(n);
  const int64_t splits = (n + rows - 1) / rows;
  cudaStream_t st = (cudaStream_t)stream;
  wls_whiten_partial<<<dim3((unsigned)splits, (unsigned)g), K7_THREADS, 0,
                       st>>>(
      (const double*)r, (const double*)J, (const double*)err,
      (double*)partial, n, p, err_stride, rows);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  int64_t blocks = (n + K7_THREADS - 1) / K7_THREADS;
  if (blocks > 528) blocks = 528;  // 4 per SM on 132 SMs; grid-stride
  wls_whiten_apply<<<dim3((unsigned)blocks, (unsigned)g), K7_THREADS,
                     (size_t)(p + 1) * sizeof(double), st>>>(
      (const double*)r, (const double*)J, (const double*)err,
      (const double*)partial, (double*)rw, (double*)jn, (double*)norms,
      (double*)chi2, n, p, err_stride, splits);
  return (int)cudaGetLastError();
}
