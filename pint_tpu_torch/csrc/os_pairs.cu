// Kernel K4: the optimal statistic's pair stage.
//
// Replaces pint_tpu/gw/os.py:86 _pair_num_den, vmapped over all
// N(N-1)/2 pairs by :93 _os_program and :122 _os_program_marg.
//
// For every pair p = (a, b), a < b, with the template spectrum phihat,
// the whitened projections z (P, m2) and M (P, m2, m2):
//
//   num[p] = sum_k z_a[k] (phihat_k z_b[k])
//   den[p] = sum_ij ((phihat_i M_a[i,j]) phihat_j) M_b[j,i]
//
// the index order of the reference's einsum "i,ij,j,ji->".  M is not
// assumed symmetric: M_b is read transposed.
//
// Order: one block per pair.  Each thread adds its strided share of
// the terms in ascending order, then a fixed tree reduction in shared
// memory combines the 256 partial sums, so the result is bit-identical
// from run to run.
//
// Bound on an H100 SXM: at P = 68, m2 = 28 the function reads 0.5 MB
// (z, M, the pair indices) and writes 36 kB, ~0.15 us.  Its least
// operations, phihat^1/2 M phihat^1/2 once per pulsar and then a
// 784-term dot product per pair, are ~3.8 MFLOP, ~0.06 us on the fp64
// tensor cores (67 TFLOP/s): bytes bound it, far under a launch's
// floor.  Each block
// reads its two M blocks (12.5 kB) from L2; M_b's transposed read is
// strided but stays in L1.

#include <cstdint>
#include <cuda_runtime.h>

#define THREADS 256

__global__ void os_pairs_kernel(const double* __restrict__ z,
                                const double* __restrict__ M,
                                const double* __restrict__ phihat,
                                const int64_t* __restrict__ ii,
                                const int64_t* __restrict__ jj,
                                double* __restrict__ num,
                                double* __restrict__ den, int64_t m2) {
  const int64_t p = blockIdx.x;
  const int64_t a = ii[p], b = jj[p];
  const double* za = z + a * m2;
  const double* zb = z + b * m2;
  const double* ma = M + a * m2 * m2;
  const double* mb = M + b * m2 * m2;
  const int tid = threadIdx.x;
  double acc_n = 0.0, acc_d = 0.0;
  for (int64_t k = tid; k < m2; k += THREADS) {
    acc_n = __dadd_rn(acc_n, __dmul_rn(za[k], __dmul_rn(phihat[k], zb[k])));
  }
  for (int64_t e = tid; e < m2 * m2; e += THREADS) {
    const int64_t i = e / m2, j = e - i * m2;
    const double term = __dmul_rn(
        __dmul_rn(__dmul_rn(phihat[i], ma[e]), phihat[j]), mb[j * m2 + i]);
    acc_d = __dadd_rn(acc_d, term);
  }
  __shared__ double sn[THREADS];
  __shared__ double sd[THREADS];
  sn[tid] = acc_n;
  sd[tid] = acc_d;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
      sn[tid] = __dadd_rn(sn[tid], sn[tid + s]);
      sd[tid] = __dadd_rn(sd[tid], sd[tid + s]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    num[p] = sn[0];
    den[p] = sd[0];
  }
}

extern "C" int os_pairs_launch(const void* z, const void* M,
                               const void* phihat, const void* ii,
                               const void* jj, void* num, void* den,
                               int64_t n_pairs, int64_t m2, void* stream) {
  os_pairs_kernel<<<(unsigned)n_pairs, THREADS, 0, (cudaStream_t)stream>>>(
      (const double*)z, (const double*)M, (const double*)phihat,
      (const int64_t*)ii, (const int64_t*)jj, (double*)num, (double*)den,
      m2);
  return (int)cudaGetLastError();
}
