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
// the products in the order of the reference's einsum "i,ij,j,ji->".
// M is not assumed symmetric: M_b is read transposed.
//
// Bound on an H100 SXM: at P = 68, m2 = 28 the function reads 0.5 MB
// (z, M) and writes 36 kB, ~0.15 us.  Its operations, the 784-term dot
// product of every pair, are ~3.8 MFLOP, ~0.06 us on the fp64 tensor
// cores: bytes bound it, far under a launch's floor, so what a design
// has to keep short is the block's chain of dependent steps.
//
// Design.  The pair stage is two P x P products read on the upper
// triangle: num = (Z diag phihat) Z^T with K = m2, and den = A B^T with
// A_a = vec(phihat_i M_a[i,j] phihat_j) and B_b = vec(M_b^T), K = m2^2.
// One block per 16 x 8 output tile (rows a, columns b) that holds a
// pair a < b; tiles wholly on or below the diagonal return at once.
// The 8 warps split K: warp w takes the rows i = w, w + 8, ... of the
// (i, j) sum, each i as ceil(m2 / 8) k-steps of j on mma.sync m16n8k8
// f64 (the A operand scaled by phihat_i phihat_j as it is loaded, the B
// operand read transposed from M_b), with every operand of a row i
// loaded before its MMAs.  num's k-steps of j go to warps by j block.
// The warps' 16 x 8 partial tiles meet in shared memory and one thread
// per output entry adds them in warp order, then writes the entry to
// its pair index in the row-major upper triangle (the order of
// pint_tpu_torch.gw.orf.pair_indices), p = a P - a (a + 1) / 2 + b - a - 1.
// Indices are 32-bit (the launcher checks P m2^2 < 2^31 and P^2 < 2^31)
// with no division; the sums have a fixed order and no
// atomics, so the result is bit-identical from run to run.  -fmad=false
// keeps the scalar scaling separately rounded; it does not reach the
// MMA, which rounds its own 8-term sums.

#include <cstdint>
#include <cuda_runtime.h>

#define THREADS 256
#define WARPS 8
#define JB 4  // k-steps of j whose operands are loaded together

__device__ __forceinline__ void mma16(double (&d)[4], double a0, double a1,
                                      double a2, double a3, double b0,
                                      double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

__global__ void __launch_bounds__(THREADS) os_pairs_kernel(
    const double* __restrict__ z, const double* __restrict__ M,
    const double* __restrict__ phihat, double* __restrict__ num, double* __restrict__ den, int P, int m2) {
  const int a0 = blockIdx.y << 4, b0 = blockIdx.x << 3;
  if (a0 >= b0 + 7) return;  // every (a, b) of the tile has a >= b
  __shared__ double part[WARPS][8][32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the lane's A rows (pulsars a) and B column (pulsar b); rows past P
  // read pulsar 0 and are zeroed
  const int ra = a0 + g, rb = a0 + g + 8, cb = b0 + g;
  const bool va = ra < P, vb = rb < P, vc = cb < P;
  const int mm = m2 * m2;
  const double* Ma = M + (va ? ra : 0) * mm;
  const double* Mb = M + (vb ? rb : 0) * mm;
  const double* Mc = M + (vc ? cb : 0) * mm;
  const int nj = (m2 + 7) >> 3;
  double dd[4] = {0.0, 0.0, 0.0, 0.0};
  for (int i = warp; i < m2; i += WARPS) {
    const double pi = phihat[i];
    for (int j0 = 0; j0 < nj; j0 += JB) {
      double a[JB][4], b[JB][2];
#pragma unroll
      for (int q = 0; q < JB; ++q) {
        const int ja = ((j0 + q) << 3) + t, jb = ja + 4;
        const bool ka = j0 + q < nj && ja < m2, kb = j0 + q < nj && jb < m2;
        const double pa = ka ? phihat[ja] : 0.0, pb = kb ? phihat[jb] : 0.0;
        a[q][0] = ka && va ? (pi * Ma[i * m2 + ja]) * pa : 0.0;
        a[q][1] = ka && vb ? (pi * Mb[i * m2 + ja]) * pa : 0.0;
        a[q][2] = kb && va ? (pi * Ma[i * m2 + jb]) * pb : 0.0;
        a[q][3] = kb && vb ? (pi * Mb[i * m2 + jb]) * pb : 0.0;
        b[q][0] = ka && vc ? Mc[ja * m2 + i] : 0.0;
        b[q][1] = kb && vc ? Mc[jb * m2 + i] : 0.0;
      }
#pragma unroll
      for (int q = 0; q < JB; ++q)
        if (j0 + q < nj)
          mma16(dd, a[q][0], a[q][1], a[q][2], a[q][3], b[q][0], b[q][1]);
    }
  }
  double dn[4] = {0.0, 0.0, 0.0, 0.0};
  for (int jq = warp; jq < nj; jq += WARPS) {
    const int ja = (jq << 3) + t, jb = ja + 4;
    const bool ka = ja < m2, kb = jb < m2;
    mma16(dn, ka && va ? z[ra * m2 + ja] : 0.0,
          ka && vb ? z[rb * m2 + ja] : 0.0, kb && va ? z[ra * m2 + jb] : 0.0,
          kb && vb ? z[rb * m2 + jb] : 0.0,
          ka && vc ? phihat[ja] * z[cb * m2 + ja] : 0.0,
          kb && vc ? phihat[jb] * z[cb * m2 + jb] : 0.0);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    part[warp][e][lane] = dd[e];
    part[warp][4 + e][lane] = dn[e];
  }
  __syncthreads();
  if (tid >= 128) return;
  // output entry (r, c) of the tile sits in lane (r & 7) * 4 + (c >> 1),
  // element (r >> 3) * 2 + (c & 1) of the accumulator
  const int r = tid >> 3, c = tid & 7;
  const int a = a0 + r, b = b0 + c;
  if (a >= b || b >= P) return;
  const int p = a * P - ((a * (a + 1)) >> 1) + b - a - 1;
  const int l = ((r & 7) << 2) + (c >> 1), e = ((r >> 3) << 1) + (c & 1);
  double sd = 0.0, sn = 0.0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    sd = sd + part[w][e][l];
    sn = sn + part[w][4 + e][l];
  }
  num[p] = sn;
  den[p] = sd;
}

extern "C" int os_pairs_launch(const void* z, const void* M,
                               const void* phihat, void* num, void* den,
                               int64_t P, int64_t m2, void* stream) {
  if (P < 2 || m2 < 1 || P * m2 * m2 >= (1LL << 31) || P * P >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((P + 7) >> 3), (unsigned)((P + 15) >> 4));
  os_pairs_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const double*)z, (const double*)M, (const double*)phihat,
      (double*)num, (double*)den, (int)P, (int)m2);
  return (int)cudaGetLastError();
}
