// Kernel K8: the Woodbury chi^2 of many residual vectors against one
// prebuilt capacity factor.
//
// Replaces the r-dependent work of pint_tpu/linalg.py:381
// woodbury_chi2_logdet_pre (with :356 woodbury_precompute's factor
// built once beside it), which the chi^2 grid (pint_tpu/grid.py:222)
// runs for every grid point.  For each of G residual vectors r_g (N,):
//
//   chi2_g = sum_i r_gi^2 / n_i - || L^-1 U^T N^-1 r_g ||^2
//
// with N = diag(n) the white noise, U = [pre | ECORR epochs | post] the
// noise basis (K = k_pre + k_e + k_post columns) and L the lower
// Cholesky factor of the capacity matrix U^T N^-1 U + Phi^-1, passed as
// lt = L^T (row k of lt is column k of L, so the substitution reads it
// coalesced).  The epoch block is the structured basis' CSR (perm,
// offsets: each epoch's rows in ascending order); rows outside every
// epoch are absent from perm.  The reference densifies U; here the
// indicator columns cost one add per row in an epoch.
//
// One block of 256 threads per residual vector, every sum in a fixed
// order (bit-identical run to run, no atomics):
//   1. s = sum_i r_i (r_i / n_i): thread t adds rows t, t + 256, ... in
//      ascending order; a fixed halving tree adds the 256 sums.
//   2. the dense columns of b = U^T N^-1 r: warp w adds rows w, w + 8,
//      ... in ascending order, lane l column l (+ 32 per chunk), so a
//      row's columns are read as one coalesced run; the 8 warps' sums
//      are added in ascending warp order.
//   3. the epoch entries of b: one thread per epoch adds its rows'
//      r_i / n_i in ascending row order.
//   4. z = L^-1 b by right-looking forward substitution in shared
//      memory: at step k every thread reads b_k, z_k = b_k / L_kk, and
//      the threads subtract L_ik z_k from their b_i, i > k, in
//      ascending k; thread 0 adds z_k^2 in ascending k.
//   chi2_g = s - sum_k z_k^2.  A NaN factor (a failed factorization)
//   gives NaN, as the reference does.
// -fmad=false keeps every product separately rounded.
//
// Bound on an H100 (3.35 TB/s; fp64 67 TFLOP/s on the tensor cores for
// the GEMM/TRSM-shaped dense product and substitution, 34 for the
// elementwise rest), at the grid's shape (G = 256, N = 10^4, 61 dense
// columns, 400 epochs, K = 461): ~1.46 MFLOP per point (2 N per dense
// column, K^2 for the substitution), ~0.006 ms, against ~27 MB of
// bytes (R once, n, the dense columns, the CSR and L once), 0.008 ms:
// the bytes bound it.  This first form is simple: one block per point,
// a barrier per substitution step, L and the dense columns re-read from
// L2 by every block.

#include <cstdint>
#include <cuda_runtime.h>

#define K8_THREADS 256
#define K8_WARPS (K8_THREADS / 32)

__global__ void __launch_bounds__(K8_THREADS)
woodbury_chi2_pre_kernel(const double* __restrict__ r,
                         const double* __restrict__ nvec,
                         const double* __restrict__ pre,
                         const int32_t* __restrict__ perm,
                         const int32_t* __restrict__ offsets,
                         const double* __restrict__ post,
                         const double* __restrict__ lt,
                         double* __restrict__ chi2, int64_t n,
                         int64_t k_pre, int64_t k_e, int64_t k_post) {
  extern __shared__ double sh[];
  const int64_t k = k_pre + k_e + k_post;
  const int64_t kd = k_pre + k_post;
  const int64_t kdp = kd > 0 ? kd : 1;
  double* b = sh;                          // k right-hand sides
  double* part = sh + k;                   // K8_WARPS x kdp
  double* red = part + K8_WARPS * kdp;     // K8_THREADS
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const double* rg = r + (int64_t)blockIdx.x * n;

  double acc = 0.0;
  for (int64_t i = t; i < n; i += K8_THREADS) {
    const double ri = rg[i];
    acc = __dadd_rn(acc, __dmul_rn(ri, ri / nvec[i]));
  }
  red[t] = acc;
  for (int64_t c0 = 0; c0 < kd; c0 += 32) {
    const int64_t c = c0 + lane;
    if (c < kd) {
      const double* base = c < k_pre ? pre + c : post + (c - k_pre);
      const int64_t ld = c < k_pre ? k_pre : k_post;
      double a = 0.0;
      for (int64_t i = warp; i < n; i += K8_WARPS)
        a = __dadd_rn(a, __dmul_rn(base[i * ld], rg[i] / nvec[i]));
      part[warp * kdp + c] = a;
    }
  }
  for (int64_t e = t; e < k_e; e += K8_THREADS) {
    double a = 0.0;
    const int32_t end = offsets[e + 1];
    for (int32_t q = offsets[e]; q < end; ++q) {
      const int64_t i = perm[q];
      a = __dadd_rn(a, rg[i] / nvec[i]);
    }
    b[k_pre + e] = a;
  }
  __syncthreads();
  for (int s = K8_THREADS / 2; s > 0; s >>= 1) {
    if (t < s) red[t] = __dadd_rn(red[t], red[t + s]);
    __syncthreads();
  }
  for (int64_t c = t; c < kd; c += K8_THREADS) {
    double a = 0.0;
    for (int w = 0; w < K8_WARPS; ++w) a = __dadd_rn(a, part[w * kdp + c]);
    b[c < k_pre ? c : c + k_e] = a;
  }
  __syncthreads();
  double zz = 0.0;
  for (int64_t kk = 0; kk < k; ++kk) {
    const double* lk = lt + kk * k;
    const double zk = b[kk] / lk[kk];
    if (t == 0) zz = __dadd_rn(zz, __dmul_rn(zk, zk));
    for (int64_t i = kk + 1 + t; i < k; i += K8_THREADS)
      b[i] = __dsub_rn(b[i], __dmul_rn(lk[i], zk));
    __syncthreads();
  }
  if (t == 0) chi2[blockIdx.x] = __dsub_rn(red[0], zz);
}

extern "C" int woodbury_chi2_pre_launch(const void* r, const void* nvec,
                                        const void* pre, const void* perm,
                                        const void* offsets,
                                        const void* post, const void* lt,
                                        void* chi2, int64_t g, int64_t n,
                                        int64_t k_pre, int64_t k_e,
                                        int64_t k_post, void* stream) {
  if (g <= 0 || g > 0x7fffffff || n <= 0 || k_pre < 0 || k_e < 0 ||
      k_post < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t kd = k_pre + k_post;
  const size_t shared = sizeof(double) *
      (size_t)(k_pre + k_e + k_post + K8_WARPS * (kd > 0 ? kd : 1) +
               K8_THREADS);
  if (shared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        woodbury_chi2_pre_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (e != cudaSuccess) return (int)e;
  }
  woodbury_chi2_pre_kernel<<<(unsigned)g, K8_THREADS, shared,
                             (cudaStream_t)stream>>>(
      (const double*)r, (const double*)nvec, (const double*)pre,
      (const int32_t*)perm, (const int32_t*)offsets, (const double*)post,
      (const double*)lt, (double*)chi2, n, k_pre, k_e, k_post);
  return (int)cudaGetLastError();
}
