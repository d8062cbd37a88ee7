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
//   S_g = G0 + phi_g^-1   (G, K, K)    and    logdet phi_g   (G,),
//
// phi_noise one row for every point (the grid) or a row a point (the
// posterior's chains, each with its own red-noise weights).  The GW
// blocks' inverses M stay in a scratch of the caller's, which K11b (at
// the end of this file) reads for the gradient.
//
// Structure.  Up to a permutation the prior is diagonal on the kn noise
// columns and, on the GW sector, m2 independent P x P blocks
//   B_{g,k} = phi_gw[g,k] orf + 1e-12 diag(|phi_gw[g,k] orf_aa| + 1e-30),
// block k on the columns kn + a m2 + k (a = 0..P-1).  The reference
// factors all of phi_dense, K^3/3 + 2 K^3 operations a point; the blocks
// need m2 P^3 (P^3/3 to factor, P^3/3 to invert L, P^3/3 for L^-T L^-1).
//
// Bound on an H100 SXM.  At pta68_500 (K = 6188, kn = 4284, P = 68,
// m2 = 28) G points read G0 once and write S G times, (1 + G) K^2
// doubles: 3.06 GB at the grid's chunk of 9 points, 0.914 ms at 3.35
// TB/s; the blocks' operations, G m2 P^3 ~ 7e7, are nothing beside that.
// Bytes bound it, so the design reads every entry of G0 once for all G
// points and writes every entry of S once, in whole 32-byte sectors.
//
// Design.  Every entry of S is written once, in whole row segments (no
// partial 32-byte sectors), and G0 is read once for all G points:
// - crn_gw_block_kernel, grid (m2, G), (P^2 + 2 P) doubles of dynamic
//   shared memory a block (2 warps for P <= 32, else 8): block (k, g)
//   loads B_{g,k} (rows P + 1 doubles apart: no bank conflicts down a
//   column), factors it (right-looking, one column a step: the pivot's
//   column scaled, then the trailing update, a lane a column, a warp its
//   rows four at a time), inverts L by forward substitution
//   column-parallel (X_cj = -(sum_{c'=j}^{c-1} L_cc' X_c'j) / L_cc, each
//   running sum kept in the upper triangle and advanced in ascending c'
//   as every row X_c' lands: the terms and order of L^-1 by rows),
//   forms M = L^-T L^-1 (M_ab summed over c >= max(a, b) in ascending
//   order) and writes it, P x P, to the scratch Mg (G m2 P^2 doubles,
//   9.3 MB at the grid's chunk: held in L2), and sum log L_aa, in
//   ascending a, to ld_blk.  A pivot that is not > 0 (a NaN among them)
//   makes its M and its log NaN, so that its entries of S are NaN, as
//   the reference's failed cho_factor makes them.
// - crn_copy_kernel, no shared memory, a row a block, chunks of 4
//   double2 a thread, each loaded once (16-byte loads where the rows
//   allow them) and stored to every point's row with streaming stores
//   (st.global.cs), so that S does not push G0 out of L2.  A noise
//   row's diagonal gets the jittered reciprocal (1 / s) / s, s =
//   sqrt(phi'), computed once per row (per row and point where each
//   point has its own weights): the arithmetic of a Cholesky and
//   two triangular solves on a diagonal entry; a GW row's entry (kn + b
//   m2 + k) of point g gets M_ab of block (k, g).
// Order: the blocks and then the copy of the GW x GW quadrant (the
// 9.5 % of S that needs M) on a stream of the launcher's own; beside
// them on the caller's stream the copy of the rest (noise rows, the GW
// rows' noise columns), at most 2 blocks an SM so that the GW blocks
// find room beside it; events join the streams before and after.  Then
// crn_logdet_kernel, one block per point, sums log s over the noise
// entries (each thread a strided run in ascending order, then a fixed
// tree) and the m2 block sums in order: logdet = 2 (noise + sum_k).
// Beside the copy the blocks run ~5x slower than alone (~120 us at the
// grid's chunk): the copy's loads and stores queue ahead of their
// shared-memory accesses, and their serial chain of P column steps
// (two barriers each) ends after the copy at 4 points.
// No atomics: the result is bit-identical from run to run, and to the
// single-pass K11 before it (the same operations on every entry).
// Indices into S are 64-bit.  -fmad=false keeps every multiply and add
// separately rounded.  P is limited by one block's shared memory: (P^2
// + 2 P) doubles within 227 kB, P <= 169 (crn_capacity_smem says what a
// P needs).

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

#define THREADS 256
// one block's shared memory on an H100 (227 kB), less the static bytes
#define SMEM_LIMIT (232448 - 64)
#define JITTER 1e-12
#define PHI_FLOOR 1e-30
// double2 (or double) chunks a copy thread holds before it stores them
#define UNROLL 4
// copy blocks resident at once (8 a streaming multiprocessor)
#define COPY_BLOCKS 1056

// a noise column's entry of phi^-1: the jittered weight's Cholesky
// pivot s = sqrt(phi'), inverted by two triangular solves, (1 / s) / s
__device__ __forceinline__ double noise_inverse(double p) {
  const double pp = p + JITTER * (fabs(p) + PHI_FLOOR);
  const double s = sqrt(pp);
  return (1.0 / s) / s;
}

__global__ void __launch_bounds__(THREADS) crn_gw_block_kernel(
    const double* __restrict__ orf, const double* __restrict__ phi_gw,
    double* __restrict__ Mg, double* __restrict__ ld_blk, int P, int m2) {
  extern __shared__ double sm[];
  const int g = blockIdx.y, k = blockIdx.x, tid = threadIdx.x;
  const int nt = blockDim.x, nw = nt >> 5, lane = tid & 31, warp = tid >> 5;
  const int ld = P + 1;     // B's row stride: odd, no bank conflicts
  double* B = sm;           // P x P, row-major
  double* tmp = sm + P * ld;  // L's diagonal
  __shared__ int bad;
  __shared__ double logsum;
  const double pg = phi_gw[(int64_t)g * m2 + k];
  for (int e = tid; e < P * P; e += nt) {
    const int a = e / P, b = e - a * P;
    double v = orf[e] * pg;
    if (a == b) v = v + JITTER * (fabs(v) + PHI_FLOOR);
    B[a * ld + b] = v;
  }
  if (tid == 0) bad = 0;
  __syncthreads();
  // Cholesky, lower, right-looking: at step j the column is scaled, then
  // B_ic -= B_ij B_cj for j < c <= i, a lane a column c (B_cj held), a
  // warp the rows i, four at a time (their loads in flight together)
  for (int j = 0; j < P; ++j) {
    const double pj = B[j * ld + j];
    const double djj = sqrt(pj);
    for (int i = j + 1 + tid; i < P; i += nt)
      B[i * ld + j] = B[i * ld + j] / djj;
    __syncthreads();  // the column is scaled; every thread read the pivot
    if (tid == 0) {
      B[j * ld + j] = djj;
      tmp[j] = djj;
      if (!(pj > 0.0)) bad = 1;
    }
    for (int c = j + 1 + lane; c < P; c += 32) {
      const double lcj = B[c * ld + j];
      int i = j + 1 + warp;
      if (i < c) i += (c - i + nw - 1) / nw * nw;  // the warp's first i >= c
      for (; i + 3 * nw < P; i += 4 * nw) {
        double x[4], l[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          x[q] = B[(i + q * nw) * ld + c];
          l[q] = B[(i + q * nw) * ld + j];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) B[(i + q * nw) * ld + c] = x[q] - l[q] * lcj;
      }
      for (; i < P; i += nw) B[i * ld + c] = B[i * ld + c] - B[i * ld + j] * lcj;
    }
    __syncthreads();
  }
  // sum log L_aa in ascending a (warp 0: lane l takes the logs of a = l,
  // l + 32, ..., lane 0 adds them in order)
  if (warp == 0) {
    double s = 0.0;
    for (int a0 = 0; a0 < P; a0 += 32) {
      const double lg = a0 + lane < P ? log(tmp[a0 + lane]) : 0.0;
      for (int q = 0; q < 32 && a0 + q < P; ++q)
        s = s + __shfl_sync(0xffffffffu, lg, q);
    }
    if (lane == 0) logsum = s;
  }
  // L^-1 in place: at step c row c of X lands (X_cc = 1 / L_cc, X_cj =
  // -acc_cj / L_cc), then acc_ij += L_ic X_cj for i > c, j <= c: a lane a
  // column j (X_cj held), a warp the rows i, four at a time; acc_ij lives
  // at B[j ld + i] (the upper triangle), from 0.0
  for (int a = warp; a < P; a += nw)
    for (int b = a + 1 + lane; b < P; b += 32) B[a * ld + b] = 0.0;
  __syncthreads();
  for (int c = 0; c < P; ++c) {
    for (int j = tid; j <= c; j += nt)
      B[c * ld + j] = j == c ? 1.0 / tmp[c] : -B[j * ld + c] / tmp[c];
    __syncthreads();
    for (int j = lane; j <= c; j += 32) {
      const double xcj = B[c * ld + j];
      int i = c + 1 + warp;
      for (; i + 3 * nw < P; i += 4 * nw) {
        double x[4], l[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          x[q] = B[j * ld + i + q * nw];
          l[q] = B[(i + q * nw) * ld + c];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) B[j * ld + i + q * nw] = x[q] + l[q] * xcj;
      }
      for (; i < P; i += nw) B[j * ld + i] = B[j * ld + i] + B[i * ld + c] * xcj;
    }
    __syncthreads();
  }
  // M_ab = M_ba = sum_{c >= max(a, b)} X_ca X_cb, to the scratch
  const bool nan = bad != 0;
  double* M = Mg + ((int64_t)g * m2 + k) * P * P;
  for (int a = warp; a < P; a += nw)
    for (int b = a + lane; b < P; b += 32) {
      double s = 0.0;
      for (int c = b; c < P; ++c) s = s + B[c * ld + a] * B[c * ld + b];
      if (nan) s = __longlong_as_double(0x7ff8000000000000LL);
      M[a * P + b] = s;
      M[b * P + a] = s;
    }
  if (tid == 0)
    ld_blk[(int64_t)g * m2 + k] =
        nan ? __longlong_as_double(0x7ff8000000000000LL) : logsum;
}

// rows [r0, r1) of every point: with GW = false every column of a noise
// row (the diagonal's reciprocal added) and a GW row's noise columns
// [0, kn); with GW = true a GW row's columns [kn, K), the blocks' M
// added on their entries.  At most 51 registers a thread, so that the GW
// blocks find room beside the first copy.
template <bool VEC, bool GW>
__global__ void __launch_bounds__(THREADS, 5) crn_copy_kernel(
    const double* __restrict__ g0, const double* __restrict__ phi_noise,
    const double* __restrict__ Mg, double* __restrict__ S, int64_t G,
    int64_t K, int64_t kn, int64_t ns, int P, int m2, int64_t r0,
    int64_t r1) {
  const int64_t PP = (int64_t)P * P;
  for (int64_t r = r0 + blockIdx.x; r < r1; r += gridDim.x) {
    double add = 0.0;
    int k = 0, a = 0;  // a GW row's block and pulsar
    if (GW) {
      a = (int)(r - kn) / m2;
      k = (int)(r - kn) - a * m2;
    } else if (r < kn) {
      add = noise_inverse(phi_noise[r]);
    }
    // M_ab of point g at Mg[g m2 P^2 + mrow + b]
    const int64_t mrow = ((int64_t)k * P + a) * P;
    const double* src = g0 + r * K;
    // the row's columns [cb, ce)
    const int64_t cb = GW ? kn : 0, ce = GW || r < kn ? K : kn;
    if (VEC) {  // K and kn even, the pointers 16-byte aligned
      const int64_t n2 = ce / 2;
      const double2* s2 = reinterpret_cast<const double2*>(src);
      for (int64_t q0 = cb / 2; q0 < n2; q0 += UNROLL * THREADS) {
        double2 v[UNROLL];
        int bx[UNROLL], by[UNROLL];  // M's column b, -1: not a block entry
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int64_t q = q0 + u * THREADS + threadIdx.x;
          v[u] = q < n2 ? s2[q] : make_double2(0.0, 0.0);
          bx[u] = by[u] = -1;
          if (GW) {
            const int c = (int)(2 * q - kn);
            if (c % m2 == k) bx[u] = c / m2;
            if ((c + 1) % m2 == k) by[u] = (c + 1) / m2;
          }
        }
        for (int64_t g = blockIdx.y; g < G; g += gridDim.y) {
          double2* d2 = reinterpret_cast<double2*>(S + (g * K + r) * K);
          const double* M = Mg + g * m2 * PP + mrow;
          const double ag =
              !GW && ns && r < kn ? noise_inverse(phi_noise[g * ns + r]) : add;
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int64_t q = q0 + u * THREADS + threadIdx.x;
            if (q < n2) {
              double2 w = v[u];
              if (!GW && 2 * q == r) w.x = w.x + ag;
              if (!GW && 2 * q + 1 == r) w.y = w.y + ag;
              if (GW && bx[u] >= 0) w.x = w.x + M[bx[u]];
              if (GW && by[u] >= 0) w.y = w.y + M[by[u]];
              __stcs(d2 + q, w);
            }
          }
        }
      }
    } else {
      for (int64_t c0 = cb; c0 < ce; c0 += UNROLL * THREADS) {
        double v[UNROLL];
        int bx[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int64_t c = c0 + u * THREADS + threadIdx.x;
          v[u] = c < ce ? src[c] : 0.0;
          bx[u] = -1;
          if (GW && c < ce && (int)(c - kn) % m2 == k)
            bx[u] = (int)(c - kn) / m2;
        }
        for (int64_t g = blockIdx.y; g < G; g += gridDim.y) {
          double* d = S + (g * K + r) * K;
          const double* M = Mg + g * m2 * PP + mrow;
          const double ag =
              !GW && ns && r < kn ? noise_inverse(phi_noise[g * ns + r]) : add;
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int64_t c = c0 + u * THREADS + threadIdx.x;
            if (c < ce)
              __stcs(d + c, bx[u] >= 0 ? v[u] + M[bx[u]]
                            : !GW && c == r ? v[u] + ag : v[u]);
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) crn_logdet_kernel(
    const double* __restrict__ phi_noise, const double* __restrict__ ld_blk,
    double* __restrict__ ld, int kn, int64_t ns, int m2) {
  __shared__ double part[THREADS];
  const int g = blockIdx.x, tid = threadIdx.x;
  double s = 0.0;
  for (int r = tid; r < kn; r += THREADS) {
    const double p = phi_noise[g * ns + r];
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
  const int64_t b = (P * (P + 1) + P) * (int64_t)sizeof(double);
  return P >= 1 && b <= SMEM_LIMIT ? (int)b : 0;
}

// the rows [r0, r1) of every point in at most `cap` blocks (0: no cap)
template <bool GW>
static cudaError_t copy_rows(const void* g0, const void* phi_noise,
                             const void* Mg, void* S, int64_t G, int64_t K,
                             int64_t kn, int64_t ns, int64_t P, int64_t m2,
                             int64_t r0, int64_t r1, int64_t cap,
                             cudaStream_t s) {
  if (r1 <= r0) return cudaSuccess;
  // a row a block, the points split over gridDim.y only where the rows
  // are too few to fill the card
  const int64_t rows = r1 - r0;
  int64_t splits = COPY_BLOCKS / rows;
  if (splits > G) splits = G;
  if (splits < 1) splits = 1;
  int64_t gx = rows;
  if (cap > 0 && gx * splits > cap) gx = cap / splits > 0 ? cap / splits : 1;
  const dim3 grid((unsigned)gx, (unsigned)splits);
  const bool vec =
      K % 2 == 0 && kn % 2 == 0 && ((uintptr_t)g0 | (uintptr_t)S) % 16 == 0;
  // an SM running the copy keeps its shared memory for the GW blocks
  // (its carveout is set while it runs; the copy uses none)
  const cudaError_t e = cudaFuncSetAttribute(
      vec ? crn_copy_kernel<true, GW> : crn_copy_kernel<false, GW>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  if (vec)
    crn_copy_kernel<true, GW><<<grid, THREADS, 0, s>>>(
        (const double*)g0, (const double*)phi_noise, (const double*)Mg,
        (double*)S, G, K, kn, ns, (int)P, (int)m2, r0, r1);
  else
    crn_copy_kernel<false, GW><<<grid, THREADS, 0, s>>>(
        (const double*)g0, (const double*)phi_noise, (const double*)Mg,
        (double*)S, G, K, kn, ns, (int)P, (int)m2, r0, r1);
  return cudaGetLastError();
}

// the launcher's own stream for the GW blocks and the events that join
// it to the caller's, one set per device, made at first use; and the
// device's SM count
struct Side {
  cudaStream_t stream;
  cudaEvent_t in, out;
  int sms;
};

static int side_of(int dev, Side** out) {
  static Side sides[64];
  static bool made[64];
  static std::mutex lock;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(lock);
  if (!made[dev]) {
    Side& x = sides[dev];
    cudaError_t e;
    if ((e = cudaDeviceGetAttribute(&x.sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaStreamCreateWithFlags(&x.stream, cudaStreamNonBlocking)) !=
            cudaSuccess ||
        (e = cudaEventCreateWithFlags(&x.in, cudaEventDisableTiming)) !=
            cudaSuccess ||
        (e = cudaEventCreateWithFlags(&x.out, cudaEventDisableTiming)) !=
            cudaSuccess)
      return (int)e;
    made[dev] = true;
  }
  *out = &sides[dev];
  return 0;
}

// Mg: G m2 P^2 doubles, each GW block's inverse (K11b reads them);
// phi_noise: point g's weights at g ns (ns = 0: one row for every point)
extern "C" int crn_capacity_launch(const void* g0, const void* phi_noise,
                                   const void* orf, const void* phi_gw,
                                   void* S, void* ld, void* ld_blk, void* Mg,
                                   int64_t G, int64_t K, int64_t kn,
                                   int64_t ns, int64_t P, int64_t m2,
                                   void* stream) {
  if (G < 1 || G > 65535 || P < 1 || m2 < 1 || kn < 0 || K != kn + P * m2 ||
      K >= (1LL << 31) || (ns != 0 && ns != kn))
    return (int)cudaErrorInvalidValue;
  const int smem = crn_capacity_smem(P);
  if (!smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      crn_gw_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  Side* side = nullptr;
  const int serr = side_of(dev, &side);
  if (serr) return serr;
  cudaStream_t s = (cudaStream_t)stream;
  // on the side stream, after the caller's work so far: the GW blocks,
  // then the quadrant's copy; beside them on the caller's stream the
  // rest of S, in 2 blocks an SM (room for the blocks beside them)
  if ((err = cudaEventRecord(side->in, s)) != cudaSuccess ||
      (err = cudaStreamWaitEvent(side->stream, side->in, 0)) != cudaSuccess)
    return (int)err;
  // 2 warps a block for a small P, 8 for a larger one
  crn_gw_block_kernel<<<dim3((unsigned)m2, (unsigned)G), P <= 32 ? 64 : 256,
                        (size_t)smem, side->stream>>>(
      (const double*)orf, (const double*)phi_gw, (double*)Mg,
      (double*)ld_blk, (int)P, (int)m2);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = copy_rows<true>(g0, phi_noise, Mg, S, G, K, kn, ns, P, m2, kn,
                             K, 0, side->stream)) != cudaSuccess ||
      (err = cudaEventRecord(side->out, side->stream)) != cudaSuccess ||
      (err = copy_rows<false>(g0, phi_noise, Mg, S, G, K, kn, ns, P, m2, 0,
                              K, 2 * (int64_t)side->sms, s)) != cudaSuccess ||
      (err = cudaStreamWaitEvent(s, side->out, 0)) != cudaSuccess)
    return (int)err;
  crn_logdet_kernel<<<(unsigned)G, THREADS, 0, s>>>(
      (const double*)phi_noise, (const double*)ld_blk, (double*)ld, (int)kn,
      ns, (int)m2);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel K11b: the backward of K11.
//
// Replaces the jax.grad that pint_tpu/gw/hmc.py:270 _dense_chi2_logdet's
// gradient takes through the dense prior's inverse and logdet
// (pint_tpu/linalg.py:223 _phi_terms, 2-D branch).  Given the cotangents
// gS (G, K, K) of S_g = G0 + phi_g^-1 and gld (G,) of logdet phi_g it
// writes those of the noise weights, gpn (G, kn), and of the GW powers,
// ggw (G, m2):
//
//   noise column j, phi' = phi_j + 1e-12 (|phi_j| + 1e-30):
//     gpn_j = (gld / phi' - gS_jj / phi'^2) (1 + 1e-12 sign phi_j);
//   GW block f, B_f = phi_gw,f orf + 1e-12 diag(|phi_gw,f orf_aa| + 1e-30)
//   = phi_gw,f W + 1e-42 I, W = dB_f / dphi_gw,f, M_f = B_f^-1 (K11's
//   scratch, kept for this), gM_f the block of gS on the rows and columns
//   kn + a m2 + f: with gB_f = gld M_f - M_f sym(gM_f) M_f,
//     ggw_f = <gB_f, W> = (gld P - sum_ab gM_f[a, b] sym(M_f)[a, b])
//             / phi_gw,f,
//   less 1e-42 tr(gB_f) / phi_gw,f, which is left out (below 1e-42
//   ||M_f|| of the rest; linalg.crn_capacity_bwd_plain says why).
//
// Bound on an H100 SXM.  A gather and a dot product: it reads gS's kn
// diagonal and m2 P^2 block entries a point, M's m2 P^2 and the weights,
// ~2.1 MB a point at the posterior's shapes (G = 4 chains, K = 6188, P =
// 68, m2 = 28), ~2.6 us for 4 points at 3.35 TB/s.  The gathered entries
// lie m2 doubles apart along a row, so each costs a 32-byte sector.
//
// Design.  One launch, grid (m2 + ceil(kn / T), G) of T threads, T the
// whole warps that P^2 entries need, at most 512: block (f < m2, g) sums
// gM_f[a, b] (M_f[a, b] + M_f[b, a]) / 2 over its P^2 entries, each
// thread a strided run in ascending order with BWD_BATCH gathered loads
// issued before it adds them, then a fixed shuffle tree a warp and the
// warps in order; the blocks past m2 take a noise entry a thread.  gS
// is read once an entry, M twice (a row and a column of a 37 kB block,
// from cache).  The gathered sectors' rate from memory sets the time (8
// chains take twice the time of 4), not the loads in flight.  No
// atomics: bit-identical from run to run.  Any P that K11 takes.
// ---------------------------------------------------------------------------

// the most threads a K11b block has; a thread's gathered entries in flight
#define BWD_THREADS 512
#define BWD_BATCH 8

__global__ void __launch_bounds__(BWD_THREADS) crn_capacity_bwd_kernel(
    const double* __restrict__ gS, const double* __restrict__ gld,
    const double* __restrict__ phi_noise, const double* __restrict__ phi_gw,
    const double* __restrict__ Mg, double* __restrict__ gpn,
    double* __restrict__ ggw, int64_t K, int64_t kn, int64_t ns, int P,
    int m2) {
  __shared__ double part[BWD_THREADS / 32];
  const int64_t g = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const double* gs = gS + g * K * K;
  const double lb = gld[g];
  if ((int)blockIdx.x >= m2) {  // a noise entry a thread
    const int64_t j = (int64_t)(blockIdx.x - m2) * nt + tid;
    if (j < kn) {
      const double p = phi_noise[g * ns + j];
      const double pp = p + JITTER * (fabs(p) + PHI_FLOOR);
      const double d = gs[j * K + j];
      const double dp = 1.0 + (p >= 0.0 ? JITTER : -JITTER);
      gpn[g * kn + j] = (lb / pp - d / (pp * pp)) * dp;
    }
    return;
  }
  const int f = blockIdx.x;
  const int pp2 = P * P;
  const double* M = Mg + (g * m2 + f) * (int64_t)pp2;
  double s = 0.0;
  for (int e0 = tid; e0 < pp2; e0 += nt * BWD_BATCH) {
    // every gathered load of the batch issued before the first add
    double x[BWD_BATCH], w[BWD_BATCH];
#pragma unroll
    for (int u = 0; u < BWD_BATCH; ++u) {
      const int e = e0 + u * nt;
      x[u] = w[u] = 0.0;
      if (e < pp2) {
        const int a = e / P, b = e - a * P;
        x[u] = gs[(kn + (int64_t)a * m2 + f) * K + kn + (int64_t)b * m2 + f];
        w[u] = 0.5 * (M[e] + M[b * P + a]);
      }
    }
#pragma unroll
    for (int u = 0; u < BWD_BATCH; ++u) s = s + x[u] * w[u];
  }
  // a fixed shuffle tree a warp, then the warps in order
  for (int o = 16; o > 0; o >>= 1) s = s + __shfl_down_sync(~0u, s, o);
  if ((tid & 31) == 0) part[tid >> 5] = s;
  __syncthreads();
  if (tid == 0) {
    double t = 0.0;
    for (int w = 0; w < nt >> 5; ++w) t = t + part[w];
    ggw[g * m2 + f] = (lb * (double)P - t) / phi_gw[g * m2 + f];
  }
}

// gS (G, K, K), gld (G,), phi_noise (point g's at g ns), phi_gw (G, m2),
// Mg (G, m2, P, P) from crn_capacity_launch; writes gpn (G, kn) and ggw
// (G, m2)
extern "C" int crn_capacity_bwd_launch(
    const void* gS, const void* gld, const void* phi_noise,
    const void* phi_gw, const void* Mg, void* gpn, void* ggw, int64_t G,
    int64_t K, int64_t kn, int64_t ns, int64_t P, int64_t m2,
    void* stream) {
  if (G < 1 || G > 65535 || P < 1 || m2 < 1 || kn < 0 || K != kn + P * m2 ||
      K >= (1LL << 31) || P * P >= (1LL << 31) || (ns != 0 && ns != kn))
    return (int)cudaErrorInvalidValue;
  // whole warps, as many as a block's P^2 entries need, at most 16
  const int64_t nt =
      P * P >= BWD_THREADS ? BWD_THREADS : (P * P + 31) / 32 * 32;
  const int64_t nx = m2 + (kn + nt - 1) / nt;
  crn_capacity_bwd_kernel<<<dim3((unsigned)nx, (unsigned)G), (unsigned)nt,
                            0, (cudaStream_t)stream>>>(
      (const double*)gS, (const double*)gld, (const double*)phi_noise,
      (const double*)phi_gw, (const double*)Mg, (double*)gpn, (double*)ggw,
      K, kn, ns, (int)P, (int)m2);
  return (int)cudaGetLastError();
}
