// Kernel K11: the dense common-red-noise capacity matrices.
//
// Replaces the prior half of pint_tpu/gw/common.py:186 _crn_lnlike_one
// (vmapped at :207, the grid program :239): the dense (K, K) prior
// phi_dense = blockdiag(diag(phi_noise), kron(orf, diag(phi_gw,g))) in
// the reference's pulsar-major column order (:194-200), its inverse by
// pint_tpu/linalg.py:223 _phi_terms' 2-D branch (a relative ridge of
// 1e-12 (|phi_ii| + 1e-30) on each diagonal entry, a Cholesky, cho_solve
// against the identity, logdet = 2 sum log diag L), and :265 _capacity's
// add onto the gram G0 = U^T N^-1 U.  For G points it writes
//
//   S_g = G0 + phi_g^-1   (G, K, K)    and    logdet phi_g   (G,).
//
// Structure.  Up to a permutation the prior is diagonal on the kn noise
// columns and, on the GW sector, m2 independent P x P blocks
//   B_{g,k} = phi_gw[g,k] orf + 1e-12 diag(|phi_gw[g,k] orf_aa| + 1e-30),
// block k on the columns kn + a m2 + k (a = 0..P-1).  The reference
// factors all of phi_dense, K^3/3 + 2 K^3 operations a point; the blocks
// need m2 P^3 (P^3/3 to factor, P^3/3 to invert L, P^3/3 for L^-T L^-1).
//
// Bound on an H100 SXM.  At pta68_500 (K = 6188, kn = 4284, P = 68,
// m2 = 28) a point reads G0 and writes S, 2 K^2 doubles = 612 MB,
// ~0.18 ms at 3.35 TB/s; its operations, ~9e6, are nothing beside that.
// Bytes bound it, so the design writes every entry of S in one pass.
//
// Design.  One launch of crn_capacity_kernel, grid (m2 + n_copy, G):
// - block (k < m2, g) copies its P rows of G0 (kn + a m2 + k) into S_g,
//   loads B_{g,k} into shared memory, factors it (right-looking, one
//   column a step), inverts L in place by rows, and after the barriers
//   overwrites the P^2 entries (kn + a m2 + k, kn + b m2 + k) of its rows
//   with G0 + (L^-T L^-1)_ab, each entry summed in ascending order (so
//   the block's inverse is exactly symmetric); it writes sum log L_aa to
//   ld_blk.  A pivot that is not > 0 (a NaN among them) makes the whole
//   block and its log NaN, as the reference's failed cho_factor does.
// - block (m2 + j, g) copies noise rows j, j + n_copy, ... of G0, the
//   thread that holds the diagonal entry adding the jittered reciprocal
//   (1 / s) / s with s = sqrt(phi'), the arithmetic of a Cholesky and
//   two triangular solves on a diagonal entry.
// Then crn_logdet_kernel, one block per point, sums log s over the noise
// entries (each thread a strided run in ascending order, then a fixed
// tree) and the m2 block sums in order: logdet = 2 (noise + sum_k).
// No atomics: the result is bit-identical from run to run.  Indices into
// S are 64-bit.  -fmad=false keeps every multiply and add separately
// rounded.  P is limited by one block's shared memory: (P^2 + P) doubles
// within 227 kB, P <= 169 (crn_capacity_smem says what a P needs).

#include <cstdint>
#include <cuda_runtime.h>

#define THREADS 256
// one block's shared memory on an H100 (227 kB), less the static bytes
#define SMEM_LIMIT (232448 - 64)
#define JITTER 1e-12
#define PHI_FLOOR 1e-30

__device__ __forceinline__ void copy_row(const double* __restrict__ src,
                                         double* __restrict__ dst, int64_t K,
                                         int64_t diag, double add) {
  // four loads in flight a thread before their stores
  for (int64_t c = threadIdx.x; c < K; c += 4 * THREADS) {
    double v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t cc = c + q * THREADS;
      v[q] = cc < K ? src[cc] : 0.0;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t cc = c + q * THREADS;
      if (cc < K) dst[cc] = cc == diag ? v[q] + add : v[q];
    }
  }
}

__global__ void __launch_bounds__(THREADS) crn_capacity_kernel(
    const double* __restrict__ g0, const double* __restrict__ phi_noise,
    const double* __restrict__ orf, const double* __restrict__ phi_gw,
    double* __restrict__ S, double* __restrict__ ld_blk, int64_t K, int kn,
    int P, int m2, int n_copy) {
  extern __shared__ double sm[];
  const int g = blockIdx.y, x = blockIdx.x, tid = threadIdx.x;
  double* Sg = S + (int64_t)g * K * K;
  if (x >= m2) {  // noise rows
    for (int r = x - m2; r < kn; r += n_copy) {
      const double p = phi_noise[r];
      const double pp = p + JITTER * (fabs(p) + PHI_FLOOR);
      const double s = sqrt(pp);
      copy_row(g0 + (int64_t)r * K, Sg + (int64_t)r * K, K, r,
               (1.0 / s) / s);
    }
    return;
  }
  const int k = x;
  double* B = sm;           // P x P, row-major
  double* tmp = sm + P * P;  // one row of L
  __shared__ int bad;
  __shared__ double logsum;
  for (int a = 0; a < P; ++a) {
    const int64_t r = kn + (int64_t)a * m2 + k;
    copy_row(g0 + r * K, Sg + r * K, K, -1, 0.0);
  }
  const double pg = phi_gw[(int64_t)g * m2 + k];
  for (int e = tid; e < P * P; e += THREADS) {
    const int a = e / P, b = e - a * P;
    double v = orf[e] * pg;
    if (a == b) v = v + JITTER * (fabs(v) + PHI_FLOOR);
    B[e] = v;
  }
  if (tid == 0) {
    bad = 0;
    logsum = 0.0;
  }
  __syncthreads();
  // Cholesky, lower, right-looking
  for (int j = 0; j < P; ++j) {
    const double pj = B[j * P + j];
    const double djj = sqrt(pj);
    __syncthreads();  // every thread has read the pivot
    for (int i = j + 1 + tid; i < P; i += THREADS)
      B[i * P + j] = B[i * P + j] / djj;
    if (tid == 0) {
      B[j * P + j] = djj;
      if (!(pj > 0.0)) bad = 1;
      logsum = logsum + log(djj);
    }
    __syncthreads();
    const int n = P - j - 1;
    for (int e = tid; e < n * n; e += THREADS) {
      const int ii = e / n, cc = e - ii * n;
      if (cc <= ii) {
        const int i = j + 1 + ii, c = j + 1 + cc;
        B[i * P + c] = B[i * P + c] - B[i * P + j] * B[c * P + j];
      }
    }
    __syncthreads();
  }
  // L^-1 in place, by rows: X_ij = -(sum_{c=j}^{i-1} L_ic X_cj) / L_ii
  for (int i = 0; i < P; ++i) {
    for (int c = tid; c <= i; c += THREADS) tmp[c] = B[i * P + c];
    __syncthreads();
    for (int j = tid; j <= i; j += THREADS) {
      double v;
      if (j == i) {
        v = 1.0 / tmp[i];
      } else {
        double s = 0.0;
        for (int c = j; c < i; ++c) s = s + tmp[c] * B[c * P + j];
        v = -s / tmp[i];
      }
      B[i * P + j] = v;
    }
    __syncthreads();
  }
  const bool nan = bad != 0;
  // (L^-T L^-1)_ab = sum_{c >= max(a, b)} X_ca X_cb onto G0's entries
  for (int e = tid; e < P * P; e += THREADS) {
    const int a = e / P, b = e - a * P;
    double s = 0.0;
    for (int c = a > b ? a : b; c < P; ++c) s = s + B[c * P + a] * B[c * P + b];
    const int64_t idx = (kn + (int64_t)a * m2 + k) * K + kn + (int64_t)b * m2 + k;
    Sg[idx] = nan ? __longlong_as_double(0x7ff8000000000000LL) : g0[idx] + s;
  }
  if (tid == 0)
    ld_blk[(int64_t)g * m2 + k] =
        nan ? __longlong_as_double(0x7ff8000000000000LL) : logsum;
}

__global__ void __launch_bounds__(THREADS) crn_logdet_kernel(
    const double* __restrict__ phi_noise, const double* __restrict__ ld_blk,
    double* __restrict__ ld, int kn, int m2) {
  __shared__ double part[THREADS];
  const int g = blockIdx.x, tid = threadIdx.x;
  double s = 0.0;
  for (int r = tid; r < kn; r += THREADS) {
    const double p = phi_noise[r];
    const double pp = p + JITTER * (fabs(p) + PHI_FLOOR);
    s = s + log(sqrt(pp));
  }
  part[tid] = s;
  __syncthreads();
  for (int w = THREADS / 2; w > 0; w >>= 1) {
    if (tid < w) part[tid] = part[tid] + part[tid + w];
    __syncthreads();
  }
  if (tid == 0) {
    double t = part[0];
    for (int k = 0; k < m2; ++k) t = t + ld_blk[(int64_t)g * m2 + k];
    ld[g] = 2.0 * t;
  }
}

// dynamic shared bytes of a GW block at P pulsars, 0 where they do not fit
extern "C" int crn_capacity_smem(int64_t P) {
  const int64_t b = (P * P + P) * (int64_t)sizeof(double);
  return P >= 1 && b <= SMEM_LIMIT ? (int)b : 0;
}

extern "C" int crn_capacity_launch(const void* g0, const void* phi_noise,
                                   const void* orf, const void* phi_gw,
                                   void* S, void* ld, void* ld_blk,
                                   int64_t G, int64_t K, int64_t kn,
                                   int64_t P, int64_t m2, void* stream) {
  if (G < 1 || G > 65535 || P < 1 || m2 < 1 || kn < 0 || K != kn + P * m2 ||
      K >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int smem = crn_capacity_smem(P);
  if (!smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      crn_capacity_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int n_copy = kn > 0 ? (int)((kn + P - 1) / P) : 0;
  cudaStream_t s = (cudaStream_t)stream;
  crn_capacity_kernel<<<dim3((unsigned)(m2 + n_copy), (unsigned)G), THREADS,
                        (size_t)smem, s>>>(
      (const double*)g0, (const double*)phi_noise, (const double*)orf,
      (const double*)phi_gw, (double*)S, (double*)ld_blk, K, (int)kn,
      (int)P, (int)m2, n_copy);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  crn_logdet_kernel<<<(unsigned)G, THREADS, 0, s>>>(
      (const double*)phi_noise, (const double*)ld_blk, (double*)ld, (int)kn,
      (int)m2);
  return (int)cudaGetLastError();
}
