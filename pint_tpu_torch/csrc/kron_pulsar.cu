// Kernels K5 and K5b: the per-pulsar capacity stage of the
// kron-structured PTA likelihood, forward and backward.
//
// Replaces pint_tpu/linalg.py:667 kron_chi2_logdet_pre's per-pulsar
// `one` (vmapped over pulsars at :701-713, and over chains by
// pint_tpu/gw/hmc.py's jax.vmap), and its jax.grad.
//
// K5, forward.  One block per (chain, pulsar), with the pulsar's grams
// g_uu (nb, nb), g_uf (nb, m2), g_ff (m2, m2), b_u (nb), b_f (m2), rr,
// ld_white shared by every chain and the chain's weights phi (nb):
//
//   cap  = g_uu + diag(1 / max(phi, 1e-30)),   L = chol(cap)
//   Z    = L^-1 [b_u | g_uf]                   (z_u | Z_uf)
//   G    = Z^T Z:   chi2 = rr - G_00,  x_a = b_f - G_0f,  M_a = g_ff - G_ff
//   X    = L^-T Z = cap^-1 [b_u | g_uf]        (written for K5b)
//   ld_a = ld_white + sum log max(phi, 1e-30) + 2 sum log L_kk
//
// (G holds the same sums as b_u^T x_u, g_uf^T x_u and g_uf^T X_uf: the
// solve's first half is shared, and M_a comes out exactly symmetric.)
// A pivot that is not > 0 (or NaN) makes every output of the block
// NaN, L included, as cho_factor does.
//
// K5b, backward, only through phi.  With dcap = -diag(dphi / phi^2),
// one block per (chain, pulsar) forms W = L^-1 in shared memory (its
// design below the forward kernel) and
//
//   dphi_k = gld / phi_k - (1 / phi_k^2) [gchi x_u[k]^2
//            + x_u[k] sum_i gx_i X_uf[k,i]
//            + sum_ij gM_ij X_uf[k,i] X_uf[k,j] + gld (cap^-1)_kk]
//
// with (cap^-1)_kk = sum_{i >= k} W_ik^2; a weight below the 1e-30
// floor gets 0, as the clamp gives.
//
// Bound on an H100 SXM: at 16 chains x 68 pulsars, nb = 63, m2 = 28,
// K5 reads the grams (3.6 MB) and phi (0.55 MB) and writes L and X
// (50 MB) and the outputs (7 MB): ~18 us of bytes.  Its operations,
// ~0.4 MFLOP a block and 0.4 GFLOP in all, are ~6 us on the fp64 tensor
// cores.  So bytes bound it, and a block's chain of dependent steps is
// what a design has to shorten.
//
// K5's design.  The capacity is padded to NBP = roundup8(nb) with the
// identity and the 1 + m2 right-hand sides to RP = roundup16(1 + m2)
// with zeros; both sit in shared memory (staged by cp.async) with row
// strides = 4 mod 8 doubles, so the fragment loads are free of bank
// conflicts.  The 8 x 8 tiles run on mma.sync m8n8k4 f64, G on m16n8k8
// (m8n8k4 peaks at half the fp64 tensor rate on an H100, see
// kron_gram.cu; K5's steps are latency-bound and 8 x 8 tiles match its
// panel).
// - Blocked right-looking Cholesky, panel 8.  One warp factors the
//   8 x 8 diagonal block in registers (shuffles, one reciprocal square
//   root per column) and inverts it; the inverse goes to an unused upper
//   tile of A.  The panel below it is then A_21 L_11^-T, the forward
//   solve's block row L_11^-1 Y_1, and the trailing update (lower tiles
//   of A_22 -= L_21 L_21^T, and Y_2 -= L_21 Z_1) are tiles on the MMA,
//   one warp per tile.  The warp that updates the next diagonal tile
//   factors it at once (look-ahead): 2 barriers a panel, ~nb/4 in the
//   factorization in place of ~3 nb.
// - G = Z^T Z: its upper 16 x 8 blocks on the MMA, straight from shared
//   memory; the log sums over one warp with a fixed-order shuffle tree.
// - Back substitution L^T X = Z by block rows from the last, with the
//   diagonal blocks' inverses and the off-diagonal updates on the MMA:
//   1 barrier a panel.
// Indices are 32-bit with 2-D thread maps (warp x lane, tile row x tile
// column); no 64-bit division anywhere.  Every shared entry has one
// owner per step and every sum a fixed order, so both kernels are
// bit-identical from run to run.  -fmad=false keeps K5b's and K5's
// scalar products and sums separately rounded; it does not reach the
// MMA, which rounds its own 4- and 8-term sums.  Occupancy: at nb = 63
// a block holds 53 kB of shared memory and 80 registers a thread, so 3
// blocks fit on an SM (the registers bind; capping them at 64 for a
// fourth block spills and measured slower), and the 1088 blocks of
// 16 chains x 68 pulsars take 2.75 waves on 132 SMs.  The launchers
// raise the dynamic limit above 48 kB.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#define THREADS 256
#define WARPS 8
#define LDL 12  // row stride of a diagonal block's inverse
#define PHI_FLOOR 1e-30
#define FULL 0xffffffffu

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ double floored(double v) {
  // max(v, floor) that keeps NaN, as torch.clamp does
  return v < PHI_FLOOR ? PHI_FLOOR : v;
}

__device__ __forceinline__ void dmma(double& d0, double& d1, double a,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

__host__ __device__ __forceinline__ int round8(int x) { return (x + 7) & ~7; }
__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) & ~15;
}

// shared doubles of one K5 block: the capacity, the right-hand sides and,
// for a capacity of fewer than 3 block rows, the diagonal blocks'
// inverses (wider ones keep them in A's unused upper tiles)
__host__ __device__ __forceinline__ int fwd_smem_doubles(int nb, int m2) {
  const int nbp = round8(nb), rp = round16(m2 + 1), nt = nbp >> 3;
  return nbp * (nbp + 4) + nbp * (rp + 4) + (nt < 3 ? nt * 8 * LDL : 0);
}

// where diagonal block kd's inverse lives (row stride: lda, or LDL in
// the separate area): A's upper tile (kd, kd + 1), the last block's in
// tile (0, nt - 1)
__device__ __forceinline__ double* li_at(double* A, double* Lx, int lda,
                                         int nt, int kd) {
  if (nt < 3) return Lx + kd * 8 * LDL;
  return kd < nt - 1 ? A + kd * 8 * lda + (kd + 1) * 8 : A + (nt - 1) * 8;
}

__device__ __forceinline__ void mma16(double (&d)[4], double a0, double a1,
                                      double a2, double a3, double b0,
                                      double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// One warp: factor the 8 x 8 diagonal block kd of A in place (lower, its
// diagonal the square roots) and write its inverse to li (row stride
// lds).  Lane l holds entries (l >> 3, l & 7) and (4 + (l >> 3), l & 7).
__device__ void diag_factor(double* A, double* li, int lds, int lda, int kd,
                            int lane, int* bad) {
  const int p0 = kd << 3;
  const int i0 = lane >> 3, m = lane & 7, i1 = i0 + 4;
  double v0 = A[(p0 + i0) * lda + p0 + m];
  double v1 = A[(p0 + i1) * lda + p0 + m];
  double rmine = 0.0;  // lane j < 8: 1 / L_jj
  bool fail = false;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // entry (i, j) sits in lane (i & 3) * 8 + j, v0 for i < 4, else v1
    const double c0 = __shfl_sync(FULL, v0, i0 * 8 + j);
    const double c1 = __shfl_sync(FULL, v1, i0 * 8 + j);
    const double e0 = __shfl_sync(FULL, v0, (m & 3) * 8 + j);
    const double e1 = __shfl_sync(FULL, v1, (m & 3) * 8 + j);
    const double f0 = __shfl_sync(FULL, v0, (j & 3) * 8 + j);
    const double f1 = __shfl_sync(FULL, v1, (j & 3) * 8 + j);
    const double d = j < 4 ? f0 : f1;
    const double cm = m < 4 ? e0 : e1;
    fail = fail || !(d > 0.0);
    const double r =
        d > 0.0 ? rsqrt(d) : __longlong_as_double(0x7ff8000000000000LL);
    const double s = d * r;
    const double l0 = c0 * r, l1 = c1 * r, lm = cm * r;
    if (m == j) {
      if (i0 == j) v0 = s;
      else if (i0 > j) v0 = l0;
      if (i1 == j) v1 = s;
      else if (i1 > j) v1 = l1;
    } else if (m > j) {
      if (m <= i0) v0 = v0 - l0 * lm;
      if (m <= i1) v1 = v1 - l1 * lm;
    }
    if (lane == j) rmine = r;
  }
  if (m <= i0) A[(p0 + i0) * lda + p0 + m] = v0;
  if (m <= i1) A[(p0 + i1) * lda + p0 + m] = v1;
  if (fail && lane == 0) *bad = 1;
  __syncwarp();
  // L_11^-1, lower: lane c < 8 forms column c by forward substitution
  const int c = lane & 7;
  double col[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const double ri = __shfl_sync(FULL, rmine, i);
    double acc = i == c ? 1.0 : 0.0;
#pragma unroll
    for (int q = 0; q < i; ++q)
      if (q >= c) acc = acc - A[(p0 + i) * lda + p0 + q] * col[q];
    col[i] = i < c ? 0.0 : acc * ri;
  }
  if (lane < 8) {
#pragma unroll
    for (int i = 0; i < 8; ++i) li[i * lds + c] = col[i];
  }
}

__global__ void __launch_bounds__(THREADS) kron_pulsar_fwd_kernel(
    const double* __restrict__ phi, const double* __restrict__ g_uu,
    const double* __restrict__ g_uf, const double* __restrict__ g_ff,
    const double* __restrict__ b_u, const double* __restrict__ b_f,
    const double* __restrict__ rr, const double* __restrict__ ld_white,
    double* __restrict__ chi2, double* __restrict__ x_out,
    double* __restrict__ m_out, double* __restrict__ ld_out,
    double* __restrict__ L_out, double* __restrict__ X_out, int n_psr,
    int nb, int m2) {
  extern __shared__ double smem[];
  __shared__ int bad;
  const int R = m2 + 1;
  const int nbp = round8(nb), rp = round16(R);
  const int nt = nbp >> 3, rt = rp >> 3;
  const int lda = nbp + 4, ldy = rp + 4;
  const int lds = nt < 3 ? LDL : lda;
  double* A = smem;             // (nbp, lda): capacity, then L (lower)
  double* Y = A + nbp * lda;    // (nbp, ldy): [b_u | g_uf], then Z, then X
  double* Lx = Y + nbp * ldy;   // (nt, 8, LDL) if nt < 3: see li_at
  const int blk = blockIdx.x;   // chain * n_psr + pulsar
  const int p = blk % n_psr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lr = lane >> 2, lc = lane & 3;
  const double* ph = phi + (size_t)blk * nb;
  const double* G = g_uu + (size_t)p * nb * nb;
  const double* GF = g_uf + (size_t)p * nb * m2;
  const double* BU = b_u + (size_t)p * nb;
  const double nan = __longlong_as_double(0x7ff8000000000000LL);

  if (tid == 0) bad = 0;
  // g_uu and [b_u | g_uf] by cp.async, the pads written directly; the
  // diagonal's 1 / phi is formed while the copies fly, then added
  for (int i = warp; i < nbp; i += WARPS) {
    for (int j = lane; j < nbp; j += 32) {
      if (i < nb && j < nb) cp_async8(A + i * lda + j, G + i * nb + j);
      else A[i * lda + j] = i == j ? 1.0 : 0.0;  // the identity pad
    }
    for (int c = lane; c < rp; c += 32) {
      if (i < nb && c < R)
        cp_async8(Y + i * ldy + c, c == 0 ? BU + i : GF + i * m2 + c - 1);
      else Y[i * ldy + c] = 0.0;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  // nb < THREADS: any nb whose block fits shared memory (nb <= 144)
  const double dinv = tid < nb ? 1.0 / floored(ph[tid]) : 0.0;
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  if (tid < nb) A[tid * lda + tid] = A[tid * lda + tid] + dinv;
  __syncthreads();
  if (warp == 0)
    diag_factor(A, li_at(A, Lx, lda, nt, 0), lds, lda, 0, lane, &bad);
  __syncthreads();

  for (int k = 0; k < nt; ++k) {
    const int p0 = k << 3;
    const double* lk = li_at(A, Lx, lda, nt, k);
    // the panel below the diagonal block, A_21 L_11^-T, and the forward
    // solve's block row Z_k = L_11^-1 Y_k, one tile per task
    const int np = nt - 1 - k;
    for (int t = warp; t < np + rt; t += WARPS) {
      double d0 = 0.0, d1 = 0.0;
      if (t < np) {
        const int r0 = (k + 1 + t) << 3;
#pragma unroll
        for (int kb = 0; kb < 8; kb += 4)
          dmma(d0, d1, A[(r0 + lr) * lda + p0 + kb + lc],
               lk[lr * lds + kb + lc]);
        A[(r0 + lr) * lda + p0 + 2 * lc] = d0;
        A[(r0 + lr) * lda + p0 + 2 * lc + 1] = d1;
      } else {
        const int c0 = (t - np) << 3;
#pragma unroll
        for (int kb = 0; kb < 8; kb += 4)
          dmma(d0, d1, lk[lr * lds + kb + lc],
               Y[(p0 + kb + lc) * ldy + c0 + lr]);
        Y[(p0 + lr) * ldy + c0 + 2 * lc] = d0;
        Y[(p0 + lr) * ldy + c0 + 2 * lc + 1] = d1;
      }
    }
    __syncthreads();
    if (np == 0) break;
    // trailing update: lower tiles of A_22 -= L_21 L_21^T and
    // Y_2 -= L_21 Z_k; warp 0 takes the next diagonal tile alone and
    // factors it straight after
    const int nsy = np * (np + 1) / 2;
    if (warp == 0) {
      const int r0 = (k + 1) << 3;
      double d0 = A[(r0 + lr) * lda + r0 + 2 * lc];
      double d1 = A[(r0 + lr) * lda + r0 + 2 * lc + 1];
#pragma unroll
      for (int kb = 0; kb < 8; kb += 4) {
        const double b = A[(r0 + lr) * lda + p0 + kb + lc];
        dmma(d0, d1, -b, b);
      }
      A[(r0 + lr) * lda + r0 + 2 * lc] = d0;
      A[(r0 + lr) * lda + r0 + 2 * lc + 1] = d1;
      __syncwarp();
      diag_factor(A, li_at(A, Lx, lda, nt, k + 1), lds, lda, k + 1, lane,
                  &bad);
    } else {
      for (int t = warp - 1; t < nsy - 1 + np * rt; t += WARPS - 1) {
        double d0, d1;
        if (t < nsy - 1) {
          // lower tile (ti, tj) of the trailing block, row-major, past
          // its first (diagonal) tile
          int u = t + 1, i = 0;
          while (u > i) {
            u -= i + 1;
            ++i;
          }
          const int ri = (k + 1 + i) << 3, cj = (k + 1 + u) << 3;
          d0 = A[(ri + lr) * lda + cj + 2 * lc];
          d1 = A[(ri + lr) * lda + cj + 2 * lc + 1];
#pragma unroll
          for (int kb = 0; kb < 8; kb += 4)
            dmma(d0, d1, -A[(ri + lr) * lda + p0 + kb + lc],
                 A[(cj + lr) * lda + p0 + kb + lc]);
          A[(ri + lr) * lda + cj + 2 * lc] = d0;
          A[(ri + lr) * lda + cj + 2 * lc + 1] = d1;
        } else {
          const int u = t - (nsy - 1);
          const int i = u / rt;
          const int ri = (k + 1 + i) << 3, c0 = (u - i * rt) << 3;
          d0 = Y[(ri + lr) * ldy + c0 + 2 * lc];
          d1 = Y[(ri + lr) * ldy + c0 + 2 * lc + 1];
#pragma unroll
          for (int kb = 0; kb < 8; kb += 4)
            dmma(d0, d1, -A[(ri + lr) * lda + p0 + kb + lc],
                 Y[(p0 + kb + lc) * ldy + c0 + lr]);
          Y[(ri + lr) * ldy + c0 + 2 * lc] = d0;
          Y[(ri + lr) * ldy + c0 + 2 * lc + 1] = d1;
        }
      }
    }
    __syncthreads();
  }
  const bool fail = bad != 0;

  // G = Z^T Z on m16n8k8: its 16 x 8 blocks (I, J), J >= 2 I, over the
  // upper triangle; chi2, x_a and M_a straight from the blocks
  const int ng = (rp >> 4) * ((rp >> 4) + 1);
  for (int t = warp; t < ng; t += WARPS) {
    int u = t, bI = 0;
    while (u >= rt - 2 * bI) {
      u -= rt - 2 * bI;
      ++bI;
    }
    const int ca = bI * 16 + lr, cb = (2 * bI + u) * 8 + lr;
    double d[4] = {0.0, 0.0, 0.0, 0.0};
    for (int kb = 0; kb < nbp; kb += 8) {
      const double* y0 = Y + (kb + lc) * ldy;
      const double* y4 = y0 + 4 * ldy;
      mma16(d, y0[ca], y0[ca + 8], y4[ca], y4[ca + 8], y0[cb], y4[cb]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = ca + 8 * (e >> 1), c = cb - lr + 2 * lc + (e & 1);
      const double g = d[e];
      if (r > c || c >= R) continue;
      if (r == 0) {
        if (c == 0) chi2[blk] = fail ? nan : rr[p] - g;
        else
          x_out[(size_t)blk * m2 + c - 1] =
              fail ? nan : b_f[(size_t)p * m2 + c - 1] - g;
      } else {
        const double v =
            fail ? nan : g_ff[(size_t)p * m2 * m2 + (r - 1) * m2 + c - 1] - g;
        double* mb = m_out + (size_t)blk * m2 * m2;
        mb[(r - 1) * m2 + c - 1] = v;
        mb[(c - 1) * m2 + r - 1] = v;
      }
    }
  }
  if (warp == WARPS - 1) {
    // log sums: lane-strided, then a fixed shuffle tree
    double s1 = 0.0, s2 = 0.0;
    for (int i = lane; i < nb; i += 32) {
      s1 = s1 + log(floored(ph[i]));
      s2 = s2 + log(A[i * lda + i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 = s1 + __shfl_down_sync(FULL, s1, off);
      s2 = s2 + __shfl_down_sync(FULL, s2, off);
    }
    if (lane == 0) ld_out[blk] = fail ? nan : ld_white[p] + s1 + 2.0 * s2;
  }
  double* Lg = L_out + (size_t)blk * nb * nb;
  for (int i = warp; i < nb; i += WARPS)
    for (int j = lane; j < nb; j += 32)
      Lg[i * nb + j] = fail ? nan : (j <= i ? A[i * lda + j] : 0.0);
  __syncthreads();

  // back substitution L^T X = Z by block rows from the last; the owner of
  // a tile of block row k - 1 applies L_kk^-T to it once it is complete
  {
    const int p0 = (nt - 1) << 3;
    const double* lk = li_at(A, Lx, lda, nt, nt - 1);
    for (int t = warp; t < rt; t += WARPS) {
      double d0 = 0.0, d1 = 0.0;
#pragma unroll
      for (int kb = 0; kb < 8; kb += 4)
        dmma(d0, d1, lk[(kb + lc) * lds + lr],
             Y[(p0 + kb + lc) * ldy + t * 8 + lr]);
      Y[(p0 + lr) * ldy + t * 8 + 2 * lc] = d0;
      Y[(p0 + lr) * ldy + t * 8 + 2 * lc + 1] = d1;
    }
  }
  __syncthreads();
  for (int k = nt - 1; k > 0; --k) {
    const int p0 = k << 3;
    for (int t = warp; t < k * rt; t += WARPS) {
      const int ti = t / rt;
      const int r0 = ti << 3, c0 = (t - ti * rt) << 3;
      double d0 = Y[(r0 + lr) * ldy + c0 + 2 * lc];
      double d1 = Y[(r0 + lr) * ldy + c0 + 2 * lc + 1];
#pragma unroll
      for (int kb = 0; kb < 8; kb += 4)
        dmma(d0, d1, -A[(p0 + kb + lc) * lda + r0 + lr],
             Y[(p0 + kb + lc) * ldy + c0 + lr]);
      if (ti == k - 1) {
        // block row k - 1 is complete: apply L_{k-1}^-T through shared
        Y[(r0 + lr) * ldy + c0 + 2 * lc] = d0;
        Y[(r0 + lr) * ldy + c0 + 2 * lc + 1] = d1;
        __syncwarp();
        const double* lk = li_at(A, Lx, lda, nt, k - 1);
        d0 = d1 = 0.0;
#pragma unroll
        for (int kb = 0; kb < 8; kb += 4)
          dmma(d0, d1, lk[(kb + lc) * lds + lr],
               Y[(r0 + kb + lc) * ldy + c0 + lr]);
        __syncwarp();
      }
      Y[(r0 + lr) * ldy + c0 + 2 * lc] = d0;
      Y[(r0 + lr) * ldy + c0 + 2 * lc + 1] = d1;
    }
    __syncthreads();
  }
  double* Xg = X_out + (size_t)blk * nb * R;
  for (int i = warp; i < nb; i += WARPS)
    for (int c = lane; c < R; c += 32)
      Xg[i * R + c] = fail ? nan : Y[i * ldy + c];
}

// ---------------------------------------------------------------------------
// K5b's design.  The block's shared memory holds L's lower 8 x 8 tiles,
// packed by block rows (tile (I, J), J <= I, at I (I + 1) / 2 + J; row
// stride LDT = 12, = 4 mod 8, so the fragment loads are free of bank
// conflicts), the capacity padded to NBP = roundup8(nb) with the
// identity.  Where the block's shared memory also holds them (always at
// m2 <= 28 and nb <= 160), X, gM and gx are staged beside the tiles;
// every input arrives by cp.async at once.
// - W = L^-1 in place of L by block rows: one warp inverts each 8 x 8
//   diagonal block (a lane per column, forward substitution); every
//   off-diagonal tile is premultiplied, L'_IJ = W_II L_IJ (a tile on
//   the MMA, one warp each); then block row I, for I = 1, 2, ..., is
//   W_IJ = -sum_{J <= K < I} L'_IK W_KJ, one warp per tile on the MMA,
//   held in registers until every warp has read row I's L' tiles.  The
//   warp that owns column block J (J mod 8) adds each new tile's column
//   sums of squares (a fixed shuffle tree) to its running
//   (cap^-1)_kk = sum_i W_ik^2 in shared memory, in block-row order.
//   2 barriers a block row, 2 nb / 8 + 2 in all.
// - T = X_uf gM^T on the MMA, a warp per 8-row block of X, and from T's
//   accumulator fragments straight away s_k = sum_i X_uf[k,i] T[k,i]
//   and q_k = sum_i gx_i X_uf[k,i], each lane's share then a fixed
//   shuffle tree over the 4 lanes of a row: T never reaches memory.
// - dphi_k, a thread per k.
// Bound on an H100 SXM at 16 chains x 68 pulsars, nb = 63, m2 = 28: it
// reads L's lower triangle (17.5 MB), X (16 MB) and gM (7 MB), ~12 us
// of bytes; its ~0.1 MFLOP a block are far below that.
// Shared memory: nt (nt + 1) / 2 tiles of 96 doubles for nt = NBP / 8,
// under the first form's nb (nb + m2) doubles wherever that fitted, so
// the narrow K5b takes every shape it took (any m2 at nb <= 184).  At
// nb = 63, m2 = 28: 54 kB with X, gM and gx staged.

#define LDT 12
#define TILE (8 * LDT)
#define MAXSLOT 3  // column blocks a warp owns: nt <= 24

__host__ __device__ __forceinline__ int pad4(int x) { return x + ((4 - x) & 7); }

// shared doubles of K5b's tiles (and dk, sx) and of its staged X, gM, gx
__host__ __device__ __forceinline__ long long bwd_tile_doubles(int nb) {
  const int nt = round8(nb) >> 3;
  return (long long)((nt * (nt + 1)) >> 1) * TILE + 2 * round8(nb);
}
__host__ __device__ __forceinline__ long long bwd_stage_doubles(int nb,
                                                                int m2) {
  return (long long)round8(nb) * pad4(m2 + 1) + (long long)m2 * pad4(m2) +
         m2;
}

// one warp: the 8 x 8 lower tile T (row stride LDT) replaced by its
// inverse, lane c < 8 forming column c
__device__ __forceinline__ void tri_inv8(double* T, int lane) {
  const int c = lane & 7;
  double col[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    double acc = i == c ? 1.0 : 0.0;
#pragma unroll
    for (int q = 0; q < i; ++q)
      if (q >= c) acc = acc - T[i * LDT + q] * col[q];
    col[i] = i < c ? 0.0 : acc / T[i * LDT + i];
  }
  __syncwarp();
  if (lane < 8) {
#pragma unroll
    for (int i = 0; i < 8; ++i) T[i * LDT + c] = col[i];
  }
  __syncwarp();
}

// d[0..7] (+)= the column sums of squares of an 8 x 8 accumulator
// fragment (lane (r, c4) holds columns 2 c4, 2 c4 + 1 of row r): a fixed
// tree over the 8 lanes of each column; the lanes of row 0 write
__device__ __forceinline__ void col_sq(double* d, double v0, double v1,
                                       int lane, bool first) {
  double q0 = v0 * v0, q1 = v1 * v1;
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    q0 = q0 + __shfl_xor_sync(FULL, q0, off);
    q1 = q1 + __shfl_xor_sync(FULL, q1, off);
  }
  if (lane < 4) {
    d[2 * lane] = first ? q0 : d[2 * lane] + q0;
    d[2 * lane + 1] = first ? q1 : d[2 * lane + 1] + q1;
  }
}

__global__ void __launch_bounds__(THREADS) kron_pulsar_bwd_kernel(
    const double* __restrict__ phi, const double* __restrict__ L,
    const double* __restrict__ X, const double* __restrict__ gchi,
    const double* __restrict__ gx, const double* __restrict__ gm,
    const double* __restrict__ gld, double* __restrict__ gphi, int nb,
    int m2, int staged) {
  extern __shared__ double smem[];
  const int nbp = round8(nb), nt = nbp >> 3, R = m2 + 1;
  const int ntt = (nt * (nt + 1)) >> 1;
  double* Lt = smem;               // packed tiles: L, then W = L^-1
  double* dk = Lt + ntt * TILE;    // (nbp) (cap^-1)_kk
  double* sx = dk + nbp;           // (nbp) gchi x_u^2 + x_u q + s
  double* Xs = sx + nbp;           // staged X (nbp, ldxs)
  const int ldxs = pad4(R), ldgs = pad4(m2);
  double* Gs = Xs + nbp * ldxs;    // staged gM (m2, ldgs)
  double* gxs = Gs + m2 * ldgs;    // staged gx (m2)
  const int blk = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lr = lane >> 2, lc = lane & 3;
  const double* Lb = L + (size_t)blk * nb * nb;
  const double* Xb = X + (size_t)blk * nb * R;
  const double* gmb = gm + (size_t)blk * m2 * m2;
  const double* gxb = gx + (size_t)blk * m2;

  // L's lower tiles by cp.async (the pads: identity, zeros above the
  // diagonal), and X, gM, gx where staged
  {
    int t = 0;
    for (int I = 0; I < nt; ++I)
      for (int J = 0; J <= I; ++J, ++t) {
        if ((t & 7) != warp) continue;
        double* T = Lt + t * TILE;
        for (int e = lane; e < 64; e += 32) {
          const int r = e >> 3, c = e & 7;
          const int gr = (I << 3) + r, gc = (J << 3) + c;
          if (gr < nb && gc <= gr) cp_async8(T + r * LDT + c, Lb + gr * nb + gc);
          else T[r * LDT + c] = gr == gc ? 1.0 : 0.0;
        }
      }
  }
  const double* Xr = Xb;
  const double* Gr = gmb;
  const double* gxr = gxb;
  int ldx = R, ldg = m2;
  if (staged) {
    for (int i = warp; i < nb; i += WARPS)
      for (int c = lane; c < R; c += 32)
        cp_async8(Xs + i * ldxs + c, Xb + i * R + c);
    for (int i = warp; i < m2; i += WARPS)
      for (int c = lane; c < m2; c += 32)
        cp_async8(Gs + i * ldgs + c, gmb + i * m2 + c);
    for (int c = tid; c < m2; c += THREADS) cp_async8(gxs + c, gxb + c);
    Xr = Xs;
    Gr = Gs;
    gxr = gxs;
    ldx = ldxs;
    ldg = ldgs;
  }
  asm volatile("cp.async.commit_group;\n" ::);
  const double gc = gchi[blk], gl = gld[blk];
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // s_k and q_k from T = X_uf gM^T, a warp per 8-row block
  for (int rt = warp; rt < nt; rt += WARPS) {
    const int row = (rt << 3) + lr;
    const bool vr = row < nb;
    const double* xrow = Xr + (vr ? row : 0) * ldx + 1;
    double s = 0.0, q = 0.0;
    for (int c0 = 0; c0 < m2; c0 += 8) {
      const int gi = c0 + lr;
      const double* grow = Gr + (gi < m2 ? gi : 0) * ldg;
      double t0 = 0.0, t1 = 0.0;
      for (int kb = 0; kb < m2; kb += 4) {
        const int j = kb + lc;
        dmma(t0, t1, vr && j < m2 ? xrow[j] : 0.0,
             gi < m2 && j < m2 ? grow[j] : 0.0);
      }
      const int i0 = c0 + 2 * lc, i1 = i0 + 1;
      const double x0 = vr && i0 < m2 ? xrow[i0] : 0.0;
      const double x1 = vr && i1 < m2 ? xrow[i1] : 0.0;
      s = s + x0 * t0;
      s = s + x1 * t1;
      q = q + (i0 < m2 ? gxr[i0] : 0.0) * x0;
      q = q + (i1 < m2 ? gxr[i1] : 0.0) * x1;
    }
    s = s + __shfl_xor_sync(FULL, s, 1);
    q = q + __shfl_xor_sync(FULL, q, 1);
    s = s + __shfl_xor_sync(FULL, s, 2);
    q = q + __shfl_xor_sync(FULL, q, 2);
    if (vr && lc == 0) {
      const double xu = xrow[-1];
      sx[row] = gc * (xu * xu) + xu * q + s;
    }
  }

  // the diagonal blocks' inverses; the owner of column block J (the
  // warp J mod 8) starts its column sums in dk
  for (int J = warp; J < nt; J += WARPS) {
    double* T = Lt + ((J * (J + 3)) >> 1) * TILE;
    tri_inv8(T, lane);
    col_sq(dk + (J << 3), T[lr * LDT + 2 * lc], T[lr * LDT + 2 * lc + 1],
           lane, true);
  }
  __syncthreads();
  // L'_IJ = W_II L_IJ below the diagonal, a warp per tile
  {
    int t = 0;
    for (int I = 1; I < nt; ++I) {
      const double* Wd = Lt + ((I * (I + 3)) >> 1) * TILE;
      const int row0 = (I * (I + 1)) >> 1;
      for (int J = 0; J < I; ++J, ++t) {
        if ((t & 7) != warp) continue;
        double* T = Lt + (row0 + J) * TILE;
        double d0 = 0.0, d1 = 0.0;
#pragma unroll
        for (int kb = 0; kb < 8; kb += 4)
          dmma(d0, d1, Wd[lr * LDT + kb + lc], T[(kb + lc) * LDT + lr]);
        __syncwarp();
        T[lr * LDT + 2 * lc] = d0;
        T[lr * LDT + 2 * lc + 1] = d1;
      }
    }
  }
  __syncthreads();
  // block rows of W: W_IJ = -sum_{J <= K < I} L'_IK W_KJ
  for (int I = 1; I < nt; ++I) {
    const int row0 = (I * (I + 1)) >> 1;
    double acc[MAXSLOT][2];
#pragma unroll
    for (int sl = 0; sl < MAXSLOT; ++sl) {
      const int J = warp + (sl << 3);
      acc[sl][0] = acc[sl][1] = 0.0;
      if (J < I) {
        for (int K = J; K < I; ++K) {
          const double* A = Lt + (row0 + K) * TILE;
          const double* B = Lt + (((K * (K + 1)) >> 1) + J) * TILE;
#pragma unroll
          for (int kb = 0; kb < 8; kb += 4)
            dmma(acc[sl][0], acc[sl][1], -A[lr * LDT + kb + lc],
                 B[(kb + lc) * LDT + lr]);
        }
      }
    }
    __syncthreads();  // row I's L' tiles are read
#pragma unroll
    for (int sl = 0; sl < MAXSLOT; ++sl) {
      const int J = warp + (sl << 3);
      if (J < I) {
        double* T = Lt + (row0 + J) * TILE;
        T[lr * LDT + 2 * lc] = acc[sl][0];
        T[lr * LDT + 2 * lc + 1] = acc[sl][1];
        col_sq(dk + (J << 3), acc[sl][0], acc[sl][1], lane, false);
      }
    }
    __syncthreads();  // row I's W tiles (and dk) are written
  }
  for (int k = tid; k < nb; k += THREADS) {
    const double v = phi[(size_t)blk * nb + k];
    double g = 0.0;
    if (v >= PHI_FLOOR) {
      const double br = sx[k] + gl * dk[k];
      g = gl / v - br / (v * v);
    }
    gphi[(size_t)blk * nb + k] = g;
  }
}

// ---------------------------------------------------------------------------
// K5w and K5bw: the wide forms of K5 and K5b, for the (nb, m2) whose
// capacity the shared-memory forms above cannot hold (the launchers in
// pint_tpu_torch/linalg.py choose by shape).  Same inputs, same outputs
// in the same layouts, same formulas; what changes is where the
// matrices live.  Panels are bs = 8, 16 or 32 columns wide: the widest
// at which both kernels' shared memory fits WIDE_SMEM_BYTES, chosen by
// wide_panel_log2 (kron_pulsar_wide_panel exports the choice).
//
// K5w: one block per (chain, pulsar).  The capacity is formed in the
// block's slice of L_out (global memory, allocated by the launcher) and
// factored there in place by a right-looking blocked Cholesky: warp 0
// factors the bs x bs diagonal block in shared memory (one lane per
// row, sqrt and divisions, a pivot not > 0 flags the block), a thread
// per row forms the panel L21 = A21 L11^-T into shared memory (row
// stride bs + 1, so a warp's 32 rows fall in 32 banks) and into L,
// a thread per column forms Z1 = L11^-1 Y1 in X_out, and the trailing
// update A22 -= L21 L21^T (lower triangle), Y2 -= L21 Z1 runs a warp per
// row, a lane per column, each sum over the panel in ascending order.
// Then G = Z^T Z gives chi2, x and M (upper half summed over rows in
// ascending order, mirrored), the two log sums take a fixed 256-way
// split and halving tree, and the back substitution L^T X = Z runs by
// panels from the last (diagonal block from shared memory, rows above
// updated a warp per row).  A failed pivot makes every output NaN.
//
// K5bw: one block per (chain, pulsar).  diag(cap^-1)_k = sum_i W_ik^2,
// W = L^-1, from column panels of W: each panel (nb x bs, in shared
// memory) solves L W_p = E_p by row blocks (the block's rows by one
// thread per column, the rows below it updated by all threads), then
// each column's squares are summed in ascending row order.  The rest is
// K5b's formula, one thread per k.
//
// Both have fixed summation orders and one owner per entry and step,
// so they are bit-identical from run to run; indices are 32-bit or
// int64 products, with no 64-bit division (the block's pulsar is one
// 32-bit modulo).  They are simple first forms: speed is later work.

__host__ __device__ __forceinline__ long long wide_fwd_smem_doubles(
    int nb, int bs) {
  return (long long)nb * (bs + 1) + bs * bs + THREADS;
}

__host__ __device__ __forceinline__ long long wide_bwd_smem_doubles(
    int nb, int bs) {
  return (long long)nb * bs + nb;
}

// one block's opt-in shared memory on an H100 (227 kB)
#define WIDE_SMEM_BYTES 232448

// log2 of the widest panel (32, 16, 8) at which both wide kernels fit,
// or -1 where none does
static int wide_panel_log2(int64_t nb) {
  if (nb <= 0 || nb > (1 << 20)) return -1;
  for (int lbs = 5; lbs >= 3; --lbs) {
    const long long f = wide_fwd_smem_doubles((int)nb, 1 << lbs);
    const long long b = wide_bwd_smem_doubles((int)nb, 1 << lbs);
    if (8 * (f > b ? f : b) <= WIDE_SMEM_BYTES) return lbs;
  }
  return -1;
}

__device__ double block_sum(double v, double* red) {
  // fixed-order sum of one value per thread (THREADS a power of two)
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = red[tid] + red[tid + s];
    __syncthreads();
  }
  const double out = red[0];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(THREADS) kron_pulsar_fwd_wide_kernel(
    const double* __restrict__ phi, const double* __restrict__ g_uu,
    const double* __restrict__ g_uf, const double* __restrict__ g_ff,
    const double* __restrict__ b_u, const double* __restrict__ b_f,
    const double* __restrict__ rr, const double* __restrict__ ld_white,
    double* __restrict__ chi2, double* __restrict__ x_out,
    double* __restrict__ m_out, double* __restrict__ ld_out,
    double* __restrict__ L_out, double* __restrict__ X_out, int n_psr,
    int nb, int m2, int lbs) {
  extern __shared__ double smem[];
  __shared__ int bad;
  const int bs = 1 << lbs;
  const int R = m2 + 1;
  const int ps = bs + 1;               // odd row stride: no bank conflict
  double* P = smem;                    // (nb, ps): panel L21 by row
  double* D = P + (size_t)nb * ps;     // (bs, bs): the diagonal block
  double* red = D + bs * bs;           // (THREADS): block sums
  const int blk = blockIdx.x;          // chain * n_psr + pulsar
  const int p = blk % n_psr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const double* ph = phi + (size_t)blk * nb;
  const double* G = g_uu + (size_t)p * nb * nb;
  const double* GF = g_uf + (size_t)p * nb * m2;
  const double* BU = b_u + (size_t)p * nb;
  double* A = L_out + (size_t)blk * nb * nb;  // capacity, then L
  double* Y = X_out + (size_t)blk * nb * R;   // [b_u | g_uf], Z, then X
  const double nan = __longlong_as_double(0x7ff8000000000000LL);

  if (tid == 0) bad = 0;
  for (int i = warp; i < nb; i += WARPS) {
    for (int j = lane; j < nb; j += 32) {
      double v = 0.0;
      if (j < i) v = G[(size_t)i * nb + j];
      else if (j == i) v = G[(size_t)i * nb + i] + 1.0 / floored(ph[i]);
      A[(size_t)i * nb + j] = v;
    }
    for (int c = lane; c < R; c += 32)
      Y[(size_t)i * R + c] = c == 0 ? BU[i] : GF[(size_t)i * m2 + c - 1];
  }
  __syncthreads();

  for (int k0 = 0; k0 < nb; k0 += bs) {
    const int kb = min(bs, nb - k0);
    for (int idx = tid; idx < bs * bs; idx += THREADS) {
      const int i = idx >> lbs, j = idx & (bs - 1);
      D[idx] = (i < kb && j <= i) ? A[(size_t)(k0 + i) * nb + k0 + j] : 0.0;
    }
    __syncthreads();
    if (warp == 0) {
      for (int j = 0; j < kb; ++j) {
        if (lane == j) {
          const double d = D[j * bs + j];
          if (!(d > 0.0)) bad = 1;
          D[j * bs + j] = sqrt(d);
        }
        __syncwarp();
        if (lane > j && lane < kb)
          D[lane * bs + j] = D[lane * bs + j] / D[j * bs + j];
        __syncwarp();
        if (lane > j && lane < kb) {
          const double lij = D[lane * bs + j];
          for (int q = j + 1; q <= lane; ++q)
            D[lane * bs + q] = D[lane * bs + q] - lij * D[q * bs + j];
        }
        __syncwarp();
      }
    }
    __syncthreads();
    for (int idx = tid; idx < kb * bs; idx += THREADS) {
      const int i = idx >> lbs, j = idx & (bs - 1);
      if (j <= i) A[(size_t)(k0 + i) * nb + k0 + j] = D[idx];
    }
    for (int i = k0 + kb + tid; i < nb; i += THREADS) {
      double* a = A + (size_t)i * nb + k0;
      for (int j = 0; j < kb; ++j) {
        double v = a[j];
        for (int q = 0; q < j; ++q)
          v = v - P[(size_t)i * ps + q] * D[j * bs + q];
        v = v / D[j * bs + j];
        P[(size_t)i * ps + j] = v;
        a[j] = v;
      }
    }
    for (int c = tid; c < R; c += THREADS) {
      for (int j = 0; j < kb; ++j) {
        double v = Y[(size_t)(k0 + j) * R + c];
        for (int q = 0; q < j; ++q)
          v = v - D[j * bs + q] * Y[(size_t)(k0 + q) * R + c];
        Y[(size_t)(k0 + j) * R + c] = v / D[j * bs + j];
      }
    }
    __syncthreads();
    for (int i = k0 + kb + warp; i < nb; i += WARPS) {
      const double* pi = P + (size_t)i * ps;
      for (int j = k0 + kb + lane; j <= i; j += 32) {
        const double* pj = P + (size_t)j * ps;
        double s = 0.0;
        for (int q = 0; q < kb; ++q) s = s + pi[q] * pj[q];
        A[(size_t)i * nb + j] = A[(size_t)i * nb + j] - s;
      }
      for (int c = lane; c < R; c += 32) {
        double s = 0.0;
        for (int q = 0; q < kb; ++q)
          s = s + pi[q] * Y[(size_t)(k0 + q) * R + c];
        Y[(size_t)i * R + c] = Y[(size_t)i * R + c] - s;
      }
    }
    __syncthreads();
  }

  // G = Z^T Z: chi2 = rr - G_00, x = b_f - G_0f, M = g_ff - G_ff
  const double* FF = g_ff + (size_t)p * m2 * m2;
  const double* BF = b_f + (size_t)p * m2;
  for (int i = warp; i < R; i += WARPS) {
    for (int j = i + lane; j < R; j += 32) {
      double s = 0.0;
      for (int k = 0; k < nb; ++k)
        s = s + Y[(size_t)k * R + i] * Y[(size_t)k * R + j];
      if (bad) s = nan;
      if (j == 0) {
        chi2[blk] = rr[p] - s;
      } else if (i == 0) {
        x_out[(size_t)blk * m2 + j - 1] = BF[j - 1] - s;
      } else {
        const double v = FF[(size_t)(i - 1) * m2 + j - 1] - s;
        m_out[((size_t)blk * m2 + i - 1) * m2 + j - 1] = v;
        m_out[((size_t)blk * m2 + j - 1) * m2 + i - 1] = v;
      }
    }
  }
  double s1 = 0.0, s2 = 0.0;
  for (int k = tid; k < nb; k += THREADS) {
    s1 = s1 + log(floored(ph[k]));
    s2 = s2 + log(A[(size_t)k * nb + k]);
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  if (tid == 0) ld_out[blk] = bad ? nan : ld_white[p] + s1 + 2.0 * s2;

  // back substitution L^T X = Z, panels from the last
  for (int k0 = ((nb - 1) >> lbs) << lbs; k0 >= 0; k0 -= bs) {
    const int kb = min(bs, nb - k0);
    for (int idx = tid; idx < bs * bs; idx += THREADS) {
      const int i = idx >> lbs, j = idx & (bs - 1);
      D[idx] = (i < kb && j <= i) ? A[(size_t)(k0 + i) * nb + k0 + j] : 0.0;
    }
    __syncthreads();
    for (int c = tid; c < R; c += THREADS) {
      for (int j = kb - 1; j >= 0; --j) {
        double v = Y[(size_t)(k0 + j) * R + c];
        for (int q = j + 1; q < kb; ++q)
          v = v - D[q * bs + j] * Y[(size_t)(k0 + q) * R + c];
        Y[(size_t)(k0 + j) * R + c] = v / D[j * bs + j];
      }
    }
    __syncthreads();
    for (int r = warp; r < k0; r += WARPS) {
      for (int c = lane; c < R; c += 32) {
        double s = 0.0;
        for (int j = 0; j < kb; ++j)
          s = s + A[(size_t)(k0 + j) * nb + r] * Y[(size_t)(k0 + j) * R + c];
        Y[(size_t)r * R + c] = Y[(size_t)r * R + c] - s;
      }
    }
    __syncthreads();
  }
  if (bad) {
    for (int i = warp; i < nb; i += WARPS) {
      for (int j = lane; j < nb; j += 32) A[(size_t)i * nb + j] = nan;
      for (int c = lane; c < R; c += 32) Y[(size_t)i * R + c] = nan;
    }
  }
}

__global__ void __launch_bounds__(THREADS) kron_pulsar_bwd_wide_kernel(
    const double* __restrict__ phi, const double* __restrict__ L,
    const double* __restrict__ X, const double* __restrict__ gchi,
    const double* __restrict__ gx, const double* __restrict__ gm,
    const double* __restrict__ gld, double* __restrict__ gphi, int nb,
    int m2, int lbs) {
  extern __shared__ double smem[];
  const int bs = 1 << lbs;
  const int R = m2 + 1;
  double* Wp = smem;                   // (nb, bs): a column panel of L^-1
  double* dk = Wp + (size_t)nb * bs;   // (nb): diag(cap^-1)
  const int blk = blockIdx.x, tid = threadIdx.x;
  const double* Lb = L + (size_t)blk * nb * nb;
  const double* Xb = X + (size_t)blk * nb * R;
  const double* gmb = gm + (size_t)blk * m2 * m2;
  const double* gxb = gx + (size_t)blk * m2;
  const int col = tid & (bs - 1), row = tid >> lbs, step = THREADS >> lbs;

  for (int k0 = 0; k0 < nb; k0 += bs) {
    const int kc = min(bs, nb - k0);
    for (int i = k0 + row; i < nb; i += step)
      Wp[(size_t)i * bs + col] = (i == k0 + col) ? 1.0 : 0.0;
    __syncthreads();
    for (int rb = k0; rb < nb; rb += bs) {
      const int kr = min(bs, nb - rb);
      if (tid < kc) {
        for (int i = rb; i < rb + kr; ++i) {
          const double* li = Lb + (size_t)i * nb;
          double w = Wp[(size_t)i * bs + tid];
          for (int q = rb; q < i; ++q) w = w - li[q] * Wp[(size_t)q * bs + tid];
          Wp[(size_t)i * bs + tid] = w / li[i];
        }
      }
      __syncthreads();
      for (int k = rb + kr + row; k < nb; k += step) {
        const double* lk = Lb + (size_t)k * nb;
        double s = 0.0;
        for (int q = rb; q < rb + kr; ++q)
          s = s + lk[q] * Wp[(size_t)q * bs + col];
        Wp[(size_t)k * bs + col] = Wp[(size_t)k * bs + col] - s;
      }
      __syncthreads();
    }
    if (tid < kc) {
      double s = 0.0;
      for (int i = k0 + tid; i < nb; ++i)
        s = s + Wp[(size_t)i * bs + tid] * Wp[(size_t)i * bs + tid];
      dk[k0 + tid] = s;
    }
    __syncthreads();
  }
  const double gc = gchi[blk];
  const double gl = gld[blk];
  for (int k = tid; k < nb; k += THREADS) {
    const double v = phi[(size_t)blk * nb + k];
    if (!(v >= PHI_FLOOR)) {
      gphi[(size_t)blk * nb + k] = 0.0;
      continue;
    }
    const double* xk = Xb + (size_t)k * R;
    const double xu = xk[0];
    double q = 0.0, s = 0.0;
    for (int i = 0; i < m2; ++i) q += gxb[i] * xk[1 + i];
    for (int i = 0; i < m2; ++i) {
      double t = 0.0;
      for (int j = 0; j < m2; ++j) t += gmb[i * m2 + j] * xk[1 + j];
      s += xk[1 + i] * t;
    }
    const double br = gc * (xu * xu) + xu * q + s + gl * dk[k];
    gphi[(size_t)blk * nb + k] = gl / v - br / (v * v);
  }
}

static int smem_limit(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}


extern "C" int kron_pulsar_fwd_launch(
    const double* phi, const double* g_uu, const double* g_uf,
    const double* g_ff, const double* b_u, const double* b_f,
    const double* rr, const double* ld_white, double* chi2, double* x_out,
    double* m_out, double* ld_out, double* L_out, double* X_out,
    int64_t n_blocks, int64_t n_psr, int64_t nb, int64_t m2,
    cudaStream_t stream) {
  const size_t bytes = sizeof(double) * fwd_smem_doubles((int)nb, (int)m2);
  int err = smem_limit((const void*)kron_pulsar_fwd_kernel, bytes);
  if (err) return err;
  kron_pulsar_fwd_kernel<<<(unsigned)n_blocks, THREADS, bytes, stream>>>(
      phi, g_uu, g_uf, g_ff, b_u, b_f, rr, ld_white, chi2, x_out, m_out,
      ld_out, L_out, X_out, (int)n_psr, (int)nb, (int)m2);
  return (int)cudaGetLastError();
}

// K5b's shared bytes at (nb, m2): the tiles, with X, gM and gx staged
// where they fit beside them; 0 where the tiles alone do not fit
static long long bwd_smem_bytes(int64_t nb, int64_t m2) {
  if (nb < 1 || nb > (MAXSLOT << 6) || m2 < 0 || m2 > (1 << 20)) return 0;
  const long long t = 8 * bwd_tile_doubles((int)nb);
  const long long s = t + 8 * bwd_stage_doubles((int)nb, (int)m2);
  return s <= WIDE_SMEM_BYTES ? s : (t <= WIDE_SMEM_BYTES ? t : 0);
}

extern "C" int kron_pulsar_bwd_launch(
    const double* phi, const double* L, const double* X, const double* gchi,
    const double* gx, const double* gm, const double* gld, double* gphi,
    int64_t n_blocks, int64_t nb, int64_t m2, cudaStream_t stream) {
  const long long bytes = bwd_smem_bytes(nb, m2);
  if (!bytes) return (int)cudaErrorInvalidValue;
  const int staged =
      bytes > 8 * bwd_tile_doubles((int)nb);  // X, gM, gx staged
  int err = smem_limit((const void*)kron_pulsar_bwd_kernel, (size_t)bytes);
  if (err) return err;
  kron_pulsar_bwd_kernel<<<(unsigned)n_blocks, THREADS, (size_t)bytes,
                           stream>>>(phi, L, X, gchi, gx, gm, gld, gphi,
                                     (int)nb, (int)m2, staged);
  return (int)cudaGetLastError();
}

// K5b's shared bytes at (nb, m2), 0 where it does not take the shape
extern "C" int kron_pulsar_bwd_smem(int64_t nb, int64_t m2) {
  return (int)bwd_smem_bytes(nb, m2);
}

// K5 blocks that fit on one SM at this width
extern "C" int kron_pulsar_fwd_occupancy(int64_t nb, int64_t m2) {
  const size_t bytes = sizeof(double) * fwd_smem_doubles((int)nb, (int)m2);
  int err = smem_limit((const void*)kron_pulsar_fwd_kernel, bytes);
  if (err) return -err;
  int n = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kron_pulsar_fwd_kernel, THREADS, bytes);
  return err ? -err : n;
}

extern "C" int kron_pulsar_fwd_wide_launch(
    const double* phi, const double* g_uu, const double* g_uf,
    const double* g_ff, const double* b_u, const double* b_f,
    const double* rr, const double* ld_white, double* chi2, double* x_out,
    double* m_out, double* ld_out, double* L_out, double* X_out,
    int64_t n_blocks, int64_t n_psr, int64_t nb, int64_t m2,
    cudaStream_t stream) {
  const int lbs = wide_panel_log2(nb);
  if (lbs < 0) return (int)cudaErrorInvalidValue;
  const size_t bytes =
      sizeof(double) * wide_fwd_smem_doubles((int)nb, 1 << lbs);
  int err = smem_limit((const void*)kron_pulsar_fwd_wide_kernel, bytes);
  if (err) return err;
  kron_pulsar_fwd_wide_kernel<<<(unsigned)n_blocks, THREADS, bytes,
                                stream>>>(
      phi, g_uu, g_uf, g_ff, b_u, b_f, rr, ld_white, chi2, x_out, m_out,
      ld_out, L_out, X_out, (int)n_psr, (int)nb, (int)m2, lbs);
  return (int)cudaGetLastError();
}

extern "C" int kron_pulsar_bwd_wide_launch(
    const double* phi, const double* L, const double* X, const double* gchi,
    const double* gx, const double* gm, const double* gld, double* gphi,
    int64_t n_blocks, int64_t nb, int64_t m2, cudaStream_t stream) {
  const int lbs = wide_panel_log2(nb);
  if (lbs < 0) return (int)cudaErrorInvalidValue;
  const size_t bytes =
      sizeof(double) * wide_bwd_smem_doubles((int)nb, 1 << lbs);
  int err = smem_limit((const void*)kron_pulsar_bwd_wide_kernel, bytes);
  if (err) return err;
  kron_pulsar_bwd_wide_kernel<<<(unsigned)n_blocks, THREADS, bytes,
                                stream>>>(
      phi, L, X, gchi, gx, gm, gld, gphi, (int)nb, (int)m2, lbs);
  return (int)cudaGetLastError();
}

// the wide forms' panel width at nb (0: too wide for either)
extern "C" int kron_pulsar_wide_panel(int64_t nb) {
  const int lbs = wide_panel_log2(nb);
  return lbs < 0 ? 0 : 1 << lbs;
}
