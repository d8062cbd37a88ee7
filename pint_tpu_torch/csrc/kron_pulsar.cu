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
// in the same layouts, same formulas.  One block per (chain, pulsar);
// the (nb, nb) matrices stay in global memory (K5w factors the capacity
// in place in its slice of L_out, with X_out as the right-hand sides'
// working storage) and pass through shared memory tile by tile by
// cp.async.  The products run on mma.sync m16n8k8 f64 (K5b's X gM^T on
// m8n8k4, reused as it is).  Panels are BS = 8, 16 or 32 columns wide:
// the widest at which both kernels' shared memory fits WIDE_SMEM_BYTES
// (wide_panel_log2; kron_pulsar_wide_panel exports it), and each kernel
// is a template over BS.  A scratch the launcher allocates
// (kron_pulsar_wide_scratch doubles a block) holds inverses of diagonal
// tiles.  Buffers one panel wide are row-major with stride BS and
// XOR-swizzled columns (pofs), so the fragment loads of both operand
// patterns are free of bank conflicts without padding; the others have
// row strides = 4 mod 8.
//
// K5w: a right-looking blocked Cholesky by panels of BS columns, the
// capacity padded to NBP = roundup(nb, BS) with the identity.
// - One warp factors the BS x BS diagonal block by 8 x 8 tiles, each
//   in registers with K5's diag_factor (shuffles, one rsqrt a column),
//   the tiles below and right of it on the MMA, and keeps the inverses
//   of its diagonal tiles (in shared memory and in the scratch).
// - The panel below it, L21 = A21 L11^-T (staged in shared memory), and
//   the forward solve's block Z1 = L11^-1 Y1 (as Z1^T = Y1^T L11^-T) are
//   block triangular solves of 16-row strips on the MMA with those tile
//   inverses, a warp a strip.
// - The trailing update, lower 16 x 8 blocks of A22 -= L21 L21^T and
//   Y2 -= L21 Z1, runs on the MMA with L21 from shared memory: the warps
//   take 16-row strips of A22 from a shared count, the longest first,
//   hold a strip's L21 fragments in registers and stream its blocks
//   through registers four at a time, the next four's loads issued
//   before this four's products.  Warp 0 first updates the next
//   diagonal block (staged by cp.async with the panel) and factors it
//   (look-ahead), then joins.  2 barriers a panel, and the panel's load.
// The first panel reads g_uu + diag(1 / phi), b_u and g_uf where later
// panels read L_out and X_out, so the capacity is never formed in a pass
// of its own.  Each panel's rows are zeroed right of its diagonal block
// beside the panel's solves and each diagonal block is written whole,
// so L's upper triangle ends exactly zero.  G = Z^T Z on the MMA (16 x 8 blocks of its upper
// half, a warp each, all rows in ascending order), the log sums in a
// fixed tree, then the back substitution L^T X = Z by panels from the
// last: L11^T X1 = Z1 by 16-column strips with the stored tile inverses,
// and the rows above updated on the MMA with L's row strip of the panel
// staged in shared memory.  A pivot not > 0 (or NaN) makes every output
// NaN.
//
// K5bw: diag(cap^-1)_k = sum_i W_ik^2, W = L^-1, by column panels of W
// (roundup16(nb) rows of BS columns in shared memory), each formed by
// 16-row blocks from its diagonal down,
//   W_I = Tinv_I (E_I - sum_{I0 <= J < I} L_IJ W_J),
// with Tinv_I the inverse of L's 16 x 16 diagonal block I (all formed
// first, a half-warp each, into the scratch).  Row block I's strip of L
// (in chunks of the depth that fit) and Tinv_I arrive by cp.async,
// issued while the previous row block is combined; the warps split the
// sum by depth on the MMA (warp w: column tile w mod BS/8, every
// (8 / (BS/8))-th J), the owner of each column tile adds the partials in
// warp order, applies Tinv_I on the MMA and adds its columns' squares in
// ascending row order.  2 barriers a row block.  The X part of the
// formula is K5b's X_uf gM^T on the MMA (s_k and q_k from its
// fragments), parked in gphi until the column's panel ends; then dphi_k
// as in K5b.
//
// Bound on an H100 SXM at 16 chains x 68 pulsars, nb = 470, m2 = 28:
// K5w's ~52 GFLOP (nb^3 / 3 + 2 nb^2 (1 + m2) a block) take 0.78 ms on
// the fp64 tensor cores, above its 2.2 GB of bytes (0.65 ms); K5bw's
// ~38 GFLOP take 0.57 ms, above its 1.1 GB.  So operations bound both at
// the widths they serve.  What holds them back is a block's chain of
// dependent steps (panels, row blocks) and, in K5w's trailing update,
// the issue rate of 8 warps an SM: the design shortens the one and
// keeps the other's loads in flight from registers.
//
// Both have fixed summation orders and one owner per entry and step, so
// they are bit-identical from run to run; indices are 32-bit (no 64-bit
// division; the block's pulsar is one 32-bit modulo).

// one block's opt-in shared memory on an H100 (227 kB), static and
// dynamic together; the dynamic area leaves room for K5w's static ints
#define WIDE_SMEM_BYTES 232448
#define WIDE_STATIC_BYTES 8
#define WIDE_SMEM_DOUBLES ((WIDE_SMEM_BYTES - WIDE_STATIC_BYTES) / 8)

// WIDE_MARK(): where a block's time goes.  Built with -DWIDE_MARKS
// (tools/torch_k5w_phases.py), thread 0 of block 0 records clock64()
// and the source line at every mark (the first 2^20); otherwise a mark
// is nothing.  WIDE_MARKS_BEGIN opens a kernel's count.
#ifdef WIDE_MARKS
#define WIDE_MARKS_MAX (1 << 20)
__device__ long long wide_mark_t[WIDE_MARKS_MAX];
__device__ int wide_mark_l[WIDE_MARKS_MAX];
#define WIDE_MARKS_BEGIN int wide_marks_n = 0
#define WIDE_MARK()                                                       \
  do {                                                                    \
    if (threadIdx.x == 0 && blockIdx.x == 0 &&                            \
        wide_marks_n < WIDE_MARKS_MAX) {                                  \
      wide_mark_t[wide_marks_n] = clock64();                              \
      wide_mark_l[wide_marks_n++] = __LINE__;                             \
    }                                                                     \
  } while (0)
#else
#define WIDE_MARKS_BEGIN (void)0
#define WIDE_MARK() (void)0
#endif

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// a warp's work area: a 16 x bs strip (and the log sums' 256 doubles)
__host__ __device__ __forceinline__ int wide_warp_area(int bs) {
  return 16 * bs > 256 ? 16 * bs : 256;
}

// K5w: the panel (NBP + 16 rows of bs), two diagonal blocks (bs x (bs +
// 4)) with their tile inverses (bs / 8 tiles of 8 x 12), the warps' areas
__host__ __device__ __forceinline__ long long wide_fwd_smem_doubles(int nb,
                                                                    int bs) {
  return (long long)(round_up(nb, bs) + 16) * bs +
         2 * (bs * (bs + 4) + (bs / 8) * 96) + WARPS * wide_warp_area(bs);
}

// K5bw with a strip of ch 16-column blocks: W's panel (roundup16(nb) x
// bs), the strip (16 x (16 ch + 4)), two 16 x 16 inverses (row stride
// 20), the warps' partials (8 x 128)
__host__ __device__ __forceinline__ long long wide_bwd_smem_doubles(int nb,
                                                                    int bs,
                                                                    int ch) {
  return (long long)round16(nb) * bs + 16LL * (16 * ch + 4) + 2 * 320 +
         WARPS * 128;
}

// the scratch a block needs: K5w's 8 x 8 tile inverses (roundup(nb, bs)
// x 8) or K5bw's 16 x 16 ones (roundup16(nb) x 16)
__host__ __device__ __forceinline__ int wide_scratch_doubles(int nb) {
  return round16(nb) * 16;
}

// K5bw's strip depth at (nb, bs): as many 16-column blocks as fit, at
// most a whole row; 0 where not one does
static int wide_bwd_chunk(int nb, int bs) {
  const long long ch =
      (WIDE_SMEM_DOUBLES - wide_bwd_smem_doubles(nb, bs, 0)) / 256;
  const int n16 = round16(nb) >> 4;
  return ch < 1 ? 0 : (ch < n16 ? (int)ch : n16);
}

// log2 of the widest panel (32, 16, 8) at which both wide kernels fit,
// or -1 where none does
static int wide_panel_log2(int64_t nb) {
  if (nb <= 0 || nb > (1 << 20)) return -1;
  for (int lbs = 5; lbs >= 3; --lbs) {
    if (wide_fwd_smem_doubles((int)nb, 1 << lbs) <= WIDE_SMEM_DOUBLES &&
        wide_bwd_chunk((int)nb, 1 << lbs) > 0)
      return lbs;
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

// entry (r, c) of a buffer one panel (BS columns) wide: row-major, the
// columns XOR-swizzled by the row so that 4 consecutive rows x 4
// columns (A fragments) and 4 rows x 8 columns (B fragments) fall in 16
// distinct bank pairs
template <int BS>
__device__ __forceinline__ int pofs(int r, int c) {
  return r * BS + (c ^ (BS == 8 ? (r & 2) << 1 : (r & 3) << 2));
}

// an m16n8k8 accumulator (rows r, r + 8; columns c, c + 1) into a
// swizzled buffer
template <int BS>
__device__ __forceinline__ void wide_store_d(double* S, int r, int c,
                                             const double (&d)[4]) {
  S[pofs<BS>(r, c)] = d[0];
  S[pofs<BS>(r, c + 1)] = d[1];
  S[pofs<BS>(r + 8, c)] = d[2];
  S[pofs<BS>(r + 8, c + 1)] = d[3];
}

// One warp: factor the BS x BS block in Dk (row stride BS + 4; its lower
// part read) by 8 x 8 tiles, as K5 factors its capacity: K5's
// diag_factor factors each diagonal tile in registers and inverts it
// into Tk (row stride 12), the tiles below it become L_ic = A_ic
// Tinv_c^T and the lower tiles right of it A_ij -= L_ic L_jc^T, on the
// MMA.  Then L11 is written whole (zeros above) to Dk and to A's rows and
// columns k0.. below nb, and the tile inverses to the scratch Tg.
template <int BS>
__device__ void wide_diag_factor(double* Dk, double* Tk, double* A,
                                 double* Tg, int k0, int nb, int lane,
                                 int* bad) {
  constexpr int LDD = BS + 4, NT = BS / 8;
  const int lr = lane >> 2, lc = lane & 3;
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    diag_factor(Dk, Tk + c * 96, 12, LDD, c, lane, bad);
    __syncwarp();
#pragma unroll
    for (int i = c + 1; i < NT; ++i) {
      double d0 = 0.0, d1 = 0.0;
#pragma unroll
      for (int kb = 0; kb < 8; kb += 4)
        dmma(d0, d1, Dk[(8 * i + lr) * LDD + 8 * c + kb + lc],
             Tk[c * 96 + lr * 12 + kb + lc]);
      __syncwarp();
      Dk[(8 * i + lr) * LDD + 8 * c + 2 * lc] = d0;
      Dk[(8 * i + lr) * LDD + 8 * c + 2 * lc + 1] = d1;
    }
    __syncwarp();
#pragma unroll
    for (int i = c + 1; i < NT; ++i)
#pragma unroll
      for (int j = c + 1; j <= i; ++j) {
        double* t = Dk + (8 * i + lr) * LDD + 8 * j + 2 * lc;
        double d0 = t[0], d1 = t[1];
#pragma unroll
        for (int kb = 0; kb < 8; kb += 4)
          dmma(d0, d1, -Dk[(8 * i + lr) * LDD + 8 * c + kb + lc],
               Dk[(8 * j + lr) * LDD + 8 * c + kb + lc]);
        t[0] = d0;
        t[1] = d1;
      }
    __syncwarp();
  }
  for (int e = lane; e < BS * BS; e += 32) {
    const int i = e / BS, j = e % BS;
    if (j > i) Dk[i * LDD + j] = 0.0;
  }
  __syncwarp();
  for (int e = lane; e < BS * BS; e += 32) {
    const int i = e / BS, j = e % BS;
    if (k0 + i < nb && k0 + j < nb) A[(k0 + i) * nb + k0 + j] = Dk[i * LDD + j];
  }
  for (int e = lane; e < NT * 64; e += 32)
    Tg[(k0 >> 3) * 64 + e] = Tk[(e >> 6) * 96 + ((e >> 3) & 7) * 12 + (e & 7)];
  __syncwarp();
}

// One warp: the 16 x BS strip S (swizzled) replaced by S L11^-T (the
// panel and the forward solve) or, BACK, by S L11^-1 (the back
// substitution), block column by block column with the diagonal tiles'
// inverses Tk.
template <int BS, bool BACK>
__device__ void wide_strip_solve(double* S, const double* Dk,
                                 const double* Tk, int lane) {
  constexpr int LDD = BS + 4, NT = BS / 8;
  const int lr = lane >> 2, lc = lane & 3;
#pragma unroll
  for (int s = 0; s < NT; ++s) {
    const int c = BACK ? NT - 1 - s : s;
    double d[4] = {S[pofs<BS>(lr, 8 * c + 2 * lc)],
                   S[pofs<BS>(lr, 8 * c + 2 * lc + 1)],
                   S[pofs<BS>(lr + 8, 8 * c + 2 * lc)],
                   S[pofs<BS>(lr + 8, 8 * c + 2 * lc + 1)]};
#pragma unroll
    for (int u = 0; u < s; ++u) {
      // the block columns solved before: B(k, n) = L11[8c + n][8cp + k],
      // or L11[8cp + k][8c + n] going back
      const int cp = BACK ? NT - 1 - u : u;
      const double b0 = BACK ? Dk[(8 * cp + lc) * LDD + 8 * c + lr]
                             : Dk[(8 * c + lr) * LDD + 8 * cp + lc];
      const double b1 = BACK ? Dk[(8 * cp + lc + 4) * LDD + 8 * c + lr]
                             : Dk[(8 * c + lr) * LDD + 8 * cp + lc + 4];
      mma16(d, -S[pofs<BS>(lr, 8 * cp + lc)], -S[pofs<BS>(lr + 8, 8 * cp + lc)],
            -S[pofs<BS>(lr, 8 * cp + lc + 4)],
            -S[pofs<BS>(lr + 8, 8 * cp + lc + 4)], b0, b1);
    }
    wide_store_d<BS>(S, lr, 8 * c + 2 * lc, d);
    __syncwarp();
    // times Tinv_c^T (B(k, n) = Tinv_c[n][k]) or, going back, Tinv_c
    const double* T = Tk + c * 96;
    double e[4] = {0.0, 0.0, 0.0, 0.0};
    mma16(e, S[pofs<BS>(lr, 8 * c + lc)], S[pofs<BS>(lr + 8, 8 * c + lc)],
          S[pofs<BS>(lr, 8 * c + lc + 4)], S[pofs<BS>(lr + 8, 8 * c + lc + 4)],
          BACK ? T[lc * 12 + lr] : T[lr * 12 + lc],
          BACK ? T[(lc + 4) * 12 + lr] : T[lr * 12 + lc + 4]);
    __syncwarp();
    wide_store_d<BS>(S, lr, 8 * c + 2 * lc, e);
    __syncwarp();
  }
}

template <int BS>
__global__ void __launch_bounds__(THREADS, 1) kron_pulsar_fwd_wide_kernel(
    const double* __restrict__ phi, const double* __restrict__ g_uu,
    const double* __restrict__ g_uf, const double* __restrict__ g_ff,
    const double* __restrict__ b_u, const double* __restrict__ b_f,
    const double* __restrict__ rr, const double* __restrict__ ld_white,
    double* __restrict__ chi2, double* __restrict__ x_out,
    double* __restrict__ m_out, double* __restrict__ ld_out,
    double* __restrict__ L_out, double* __restrict__ X_out,
    double* __restrict__ scratch, int n_psr, int nb, int m2) {
  constexpr int NT8 = BS / 8, LDD = BS + 4, LQ = BS < 16 ? 1 : BS / 16;
  constexpr int DKS = BS * LDD + NT8 * 96;  // one diagonal block's set
  constexpr int WA = 16 * BS > 256 ? 16 * BS : 256;
  constexpr int TB = 4;  // column tiles a batch of the trailing update
  extern __shared__ double smem[];
  WIDE_MARKS_BEGIN;
  __shared__ int bad, strips;  // failed pivot; trailing strips taken
  const int R = m2 + 1;
  const int nbp = round_up(nb, BS), nt = nbp >> 3, np = nbp / BS;
  double* P = smem;                   // (nbp + 16, BS), swizzled: the panel
  double* Dks = P + (nbp + 16) * BS;  // 2 x [(BS, LDD) L11, NT8 x (8, 12)
                                      // its tile inverses], by panel parity
  const int blk = blockIdx.x;         // chain * n_psr + pulsar
  const int p = blk % n_psr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lr = lane >> 2, lc = lane & 3;
  double* wa = Dks + 2 * DKS + warp * WA;  // this warp's area
  const double* ph = phi + (size_t)blk * nb;
  const double* G = g_uu + (size_t)p * nb * nb;
  const double* GF = g_uf + (size_t)p * nb * m2;
  const double* BU = b_u + (size_t)p * nb;
  double* A = L_out + (size_t)blk * nb * nb;  // capacity, then L
  double* Y = X_out + (size_t)blk * nb * R;   // [b_u | g_uf], Z, then X
  double* Tg = scratch + (size_t)blk * wide_scratch_doubles(nb);
  const double nan = __longlong_as_double(0x7ff8000000000000LL);

  // the capacity's entry (i, j), j <= i, identity-padded: at the first
  // panel g_uu + diag(1 / phi), later L_out; the right-hand sides alike
  auto cap = [&](bool first, int i, int j) -> double {
    if (i >= nb || j >= nb) return i == j ? 1.0 : 0.0;
    if (!first) return A[i * nb + j];
    const double g = G[i * nb + j];
    return i == j ? g + 1.0 / floored(ph[i]) : g;
  };
  auto rhs = [&](bool first, int i, int c) -> double {
    if (i >= nb || c >= R) return 0.0;
    if (!first) return Y[i * R + c];
    return c == 0 ? BU[i] : GF[i * m2 + c - 1];
  };
  auto zv = [&](int i, int c) -> double {
    return i < nb && c < R ? Y[i * R + c] : 0.0;
  };
  const int ny = (R + 15) >> 4, nyt = (R + 7) >> 3;
  // Y[i][c] -= sum_{kk < BS} A(i, kk) Y[z0 + kk][c] in 16 x 8 blocks, rows
  // i = 16 q + .. of ybase.. (those below ylim), q < nqy: a column tile
  // (or a share of its rows) a warp, Z's fragments loaded once, the
  // blocks' loads issued TB at a time; afrag(q, kb, a) gives A's
  // fragment
  auto y_update = [&](bool first, int nqy, int ybase, int ylim, int z0,
                      auto afrag) {
    const int gy = nyt >= WARPS ? 1 : WARPS / nyt;
    for (int cy = warp / gy; cy < nyt; cy += WARPS / gy) {
      double bz[NT8][2];
#pragma unroll
      for (int kb = 0; kb < NT8; ++kb) {
        bz[kb][0] = zv(z0 + 8 * kb + lc, 8 * cy + lr);
        bz[kb][1] = zv(z0 + 8 * kb + lc + 4, 8 * cy + lr);
      }
      for (int q0 = warp % gy; q0 < nqy; q0 += TB * gy) {
        double d[TB][4];
#pragma unroll
        for (int u = 0; u < TB; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = q0 + u * gy;
            const int i = ybase + 16 * q + lr + 8 * (e >> 1);
            d[u][e] = q < nqy && i < ylim
                          ? rhs(first, i, 8 * cy + 2 * lc + (e & 1)) : 0.0;
          }
#pragma unroll
        for (int u = 0; u < TB; ++u) {
          const int q = q0 + u * gy;
          if (q >= nqy) break;
#pragma unroll
          for (int kb = 0; kb < NT8; ++kb) {
            double a[4];
            afrag(q, kb, a);
            mma16(d[u], -a[0], -a[1], -a[2], -a[3], bz[kb][0], bz[kb][1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = ybase + 16 * q + lr + 8 * (e >> 1);
            const int c = 8 * cy + 2 * lc + (e & 1);
            if (i < ylim && i < nb && c < R) Y[i * R + c] = d[u][e];
          }
        }
      }
    }
  };

  if (tid == 0) bad = 0;
  __syncthreads();
  WIDE_MARK();
  if (warp == 0) {
    for (int e = lane; e < BS * BS; e += 32) {
      const int i = e / BS, j = e % BS;
      Dks[i * LDD + j] = j <= i ? cap(true, i, j) : 0.0;
    }
    __syncwarp();
    wide_diag_factor<BS>(Dks, Dks + BS * LDD, A, Tg, 0, nb, lane, &bad);
  }

  for (int k = 0; k < np; ++k) {
    const bool first = k == 0, ahead = k + 1 < np;
    const int c0 = k * BS;         // the panel's first column
    const int r1 = c0 + BS;        // the first row below its diagonal block
    const int t1 = r1 >> 3;
    const int nq = (nbp - r1 + 15) >> 4;  // 16-row strips below it
    double* Dk = Dks + (k & 1) * DKS;     // L11 and its tile inverses
    double* Tk = Dk + BS * LDD;
    double* Dn = Dks + ((k + 1) & 1) * DKS;  // the next diagonal block
    // the panel below the diagonal block into P (zero past nb), the next
    // diagonal block's lower part into Dn
    for (int e = tid; e < nq * 16 * BS; e += THREADS) {
      const int r = e / BS, c = e % BS, gi = r1 + r;
      double* dst = P + pofs<BS>(r, c);
      if (gi < nb) cp_async8(dst, (first ? G : A) + gi * nb + c0 + c);
      else *dst = 0.0;
    }
    if (ahead)
      for (int e = tid; e < BS * BS; e += THREADS) {
        const int i = e / BS, j = e % BS;
        double* dst = Dn + i * LDD + j;
        if (j <= i && r1 + i < nb)
          cp_async8(dst, (first ? G : A) + (r1 + i) * nb + r1 + j);
        else *dst = i == j ? 1.0 : 0.0;
      }
    if (tid == 0) strips = 0;
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    WIDE_MARK();
    // the panel's strips: L21 = A21 L11^-T, 16 rows a task, and
    // Z1^T = Y1^T L11^-T, 16 right-hand sides a task; then the panel's
    // rows right of its diagonal block are zeroed (L's upper triangle)
    for (int t = warp; t < nq + ny; t += WARPS) {
      if (t < nq) {
        double* S = P + t * 16 * BS;
        wide_strip_solve<BS, false>(S, Dk, Tk, lane);
        for (int e = lane; e < 16 * BS; e += 32) {
          const int m = e / BS, c = e % BS, gi = r1 + 16 * t + m;
          if (gi < nb) A[gi * nb + c0 + c] = S[pofs<BS>(m, c)];
        }
      } else {
        const int y0 = (t - nq) << 4;
        for (int e = lane; e < 16 * BS; e += 32) {
          const int kk = e >> 4, m = e & 15;
          wa[pofs<BS>(m, kk)] = rhs(first, c0 + kk, y0 + m);
        }
        __syncwarp();
        wide_strip_solve<BS, false>(wa, Dk, Tk, lane);
        for (int e = lane; e < 16 * BS; e += 32) {
          const int kk = e >> 4, m = e & 15;
          if (c0 + kk < nb && y0 + m < R)
            Y[(c0 + kk) * R + y0 + m] = wa[pofs<BS>(m, kk)];
        }
      }
      __syncwarp();
    }
    for (int i = c0 + warp; i < c0 + BS && i < nb; i += WARPS)
      for (int j = r1 + lane; j < nb; j += 32) A[i * nb + j] = 0.0;
    __syncthreads();
    WIDE_MARK();
    if (!ahead) break;

    // warp 0: the next diagonal block's lower 16 x 8 blocks, then its
    // factorization (look-ahead), before it joins the trailing update
    if (warp == 0) {
      for (int q = 0; q < LQ; ++q)
        for (int j = 0; j < NT8 && 8 * j <= 16 * q + 15; ++j) {
          double d[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 16 * q + lr + 8 * (e >> 1), jj = 8 * j + 2 * lc + (e & 1);
            d[e] = i < BS ? Dn[i * LDD + jj] : 0.0;
            if (first && i == jj && r1 + i < nb)
              d[e] = d[e] + 1.0 / floored(ph[r1 + i]);
          }
#pragma unroll
          for (int kb = 0; kb < BS; kb += 8)
            mma16(d, -P[pofs<BS>(16 * q + lr, kb + lc)],
                  -P[pofs<BS>(16 * q + lr + 8, kb + lc)],
                  -P[pofs<BS>(16 * q + lr, kb + lc + 4)],
                  -P[pofs<BS>(16 * q + lr + 8, kb + lc + 4)],
                  P[pofs<BS>(8 * j + lr, kb + lc)],
                  P[pofs<BS>(8 * j + lr, kb + lc + 4)]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 16 * q + lr + 8 * (e >> 1), jj = 8 * j + 2 * lc + (e & 1);
            if (i < BS) Dn[i * LDD + jj] = d[e];
          }
        }
      __syncwarp();
      WIDE_MARK();
      wide_diag_factor<BS>(Dn, Dn + BS * LDD, A, Tg, r1, nb, lane, &bad);
      WIDE_MARK();
    }
    {
      // every warp: the lower 16 x 8 blocks (q, j) of A22 outside the next
      // diagonal block, rows r1 + 16 q, column tile j.  A warp takes whole
      // row strips from a shared count, the longest first, holds the
      // strip's -L21 fragments in registers and walks its tiles TB at a
      // time, the next TB's loads issued before this TB's products; only
      // blocks at the diagonal or past nb check bounds.  Which warp
      // takes a strip changes none of its arithmetic.
      const double* src = first ? G : A;
      double af[NT8][4];
      double cb0[TB][4], cb1[TB][4];
      for (;;) {
        int sq = 0;
        if (lane == 0) sq = atomicAdd(&strips, 1);
        sq = __shfl_sync(FULL, sq, 0);
        if (sq >= nq) break;
        const int q = nq - 1 - sq;
        const int j0 = q < LQ && BS > 8 ? t1 + NT8 : t1;
        const int j1 = min(nt, t1 + 2 * q + 2), jd = t1 + 2 * q;
        if (j0 >= j1) continue;
#pragma unroll
        for (int kb = 0; kb < NT8; ++kb) {
          af[kb][0] = -P[pofs<BS>(16 * q + lr, 8 * kb + lc)];
          af[kb][1] = -P[pofs<BS>(16 * q + lr + 8, 8 * kb + lc)];
          af[kb][2] = -P[pofs<BS>(16 * q + lr, 8 * kb + lc + 4)];
          af[kb][3] = -P[pofs<BS>(16 * q + lr + 8, 8 * kb + lc + 4)];
        }
        const int ia = r1 + 16 * q + lr;  // this lane's rows ia, ia + 8
        const bool rows_in = r1 + 16 * q + 15 < nb;
        auto load = [&](int jb, double(&cb)[TB][4]) {
          if (rows_in && jb + TB - 1 < jd) {
#pragma unroll
            for (int t = 0; t < TB; ++t) {
              const double* c = src + ia * nb + 8 * (jb + t) + 2 * lc;
              cb[t][0] = c[0];
              cb[t][1] = c[1];
              cb[t][2] = c[8 * nb];
              cb[t][3] = c[8 * nb + 1];
            }
            return;
          }
#pragma unroll
          for (int t = 0; t < TB; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = ia + 8 * (e >> 1), jj = 8 * (jb + t) + 2 * lc + (e & 1);
              double v = i == jj ? 1.0 : 0.0;
              if (jb + t < j1 && i < nb && jj <= i) {
                v = src[i * nb + jj];
                if (first && i == jj) v = v + 1.0 / floored(ph[i]);
              }
              cb[t][e] = v;
            }
        };
        auto update = [&](int jb, double(&cb)[TB][4]) {
          const bool inner = rows_in && jb + TB - 1 < jd;
#pragma unroll
          for (int t = 0; t < TB; ++t) {
            const int j = jb + t;
            if (j >= j1) break;
#pragma unroll
            for (int kb = 0; kb < NT8; ++kb)
              mma16(cb[t], af[kb][0], af[kb][1], af[kb][2], af[kb][3],
                    P[pofs<BS>(8 * j - r1 + lr, 8 * kb + lc)],
                    P[pofs<BS>(8 * j - r1 + lr, 8 * kb + lc + 4)]);
            if (inner) {
              double* c = A + ia * nb + 8 * j + 2 * lc;
              c[0] = cb[t][0];
              c[1] = cb[t][1];
              c[8 * nb] = cb[t][2];
              c[8 * nb + 1] = cb[t][3];
              continue;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = ia + 8 * (e >> 1), jj = 8 * j + 2 * lc + (e & 1);
              // not above the diagonal's tiles, not in the factored next
              // block
              if (i < nb && jj < nb && (jj >> 3) <= (i >> 3) && i >= r1 + BS)
                A[i * nb + jj] = cb[t][e];
            }
          }
        };
        load(j0, cb0);
        for (int jb = j0; jb < j1; jb += 2 * TB) {
          if (jb + TB < j1) load(jb + TB, cb1);
          update(jb, cb0);
          if (jb + TB >= j1) break;
          if (jb + 2 * TB < j1) load(jb + 2 * TB, cb0);
          update(jb + TB, cb1);
        }
      }
    }
    // Y2 -= L21 Z1
    y_update(first, nq, r1, nb, c0, [&](int q, int kb, double(&a)[4]) {
      a[0] = P[pofs<BS>(16 * q + lr, 8 * kb + lc)];
      a[1] = P[pofs<BS>(16 * q + lr + 8, 8 * kb + lc)];
      a[2] = P[pofs<BS>(16 * q + lr, 8 * kb + lc + 4)];
      a[3] = P[pofs<BS>(16 * q + lr + 8, 8 * kb + lc + 4)];
    });
    __syncthreads();
    WIDE_MARK();
  }
  const bool fail = bad != 0;

  // G = Z^T Z on m16n8k8: its 16 x 8 blocks (I, J), J >= 2 I, over the
  // upper triangle, all rows in ascending order; chi2, x_a and M_a
  // straight from the blocks
  {
    const int rp = round16(R), rt = rp >> 3, nb8 = round8(nb);
    const int ng = (rp >> 4) * ((rp >> 4) + 1);
    for (int t = warp; t < ng; t += WARPS) {
      int u = t, bI = 0;
      while (u >= rt - 2 * bI) {
        u -= rt - 2 * bI;
        ++bI;
      }
      const int ca = bI * 16 + lr, cb = (2 * bI + u) * 8 + lr;
      double d[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 4
      for (int kb = 0; kb < nb8; kb += 8) {
        const int r0 = kb + lc, r4 = r0 + 4;
        mma16(d, zv(r0, ca), zv(r0, ca + 8), zv(r4, ca), zv(r4, ca + 8),
              zv(r0, cb), zv(r4, cb));
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
  }
  {
    double s1 = 0.0, s2 = 0.0;
    for (int i = tid; i < nb; i += THREADS) {
      s1 = s1 + log(floored(ph[i]));
      s2 = s2 + log(A[i * nb + i]);
    }
    double* red = Dks + 2 * DKS;  // the warps' areas, free here
    s1 = block_sum(s1, red);
    s2 = block_sum(s2, red);
    if (tid == 0) ld_out[blk] = fail ? nan : ld_white[p] + s1 + 2.0 * s2;
  }

  // back substitution L^T X = Z by panels from the last
  double* Dk = Dks;
  double* Tk = Dk + BS * LDD;
  for (int k = np - 1; k >= 0; --k) {
    const int c0 = k * BS, w16 = round16(c0), lds = w16 + 4;
    // L11 and its tile inverses (first group), L's row strip of the
    // panel left of L11 (rows c0.., columns 0..c0; second group)
    for (int e = tid; e < BS * BS; e += THREADS) {
      const int i = e / BS, j = e % BS;
      double* dst = Dk + i * LDD + j;
      if (j <= i && c0 + i < nb) cp_async8(dst, A + (c0 + i) * nb + c0 + j);
      else *dst = i == j ? 1.0 : 0.0;
    }
    for (int e = tid; e < NT8 * 64; e += THREADS)
      cp_async8(Tk + (e >> 6) * 96 + ((e >> 3) & 7) * 12 + (e & 7),
                Tg + k * NT8 * 64 + e);
    asm volatile("cp.async.commit_group;\n" ::);
    for (int i = warp; i < BS; i += WARPS)
      for (int j = lane; j < w16; j += 32) {
        double* dst = P + i * lds + j;
        if (c0 + i < nb && j < c0) cp_async8(dst, A + (c0 + i) * nb + j);
        else *dst = 0.0;
      }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    WIDE_MARK();
    // X1^T = Z1^T L11^-1, 16 right-hand sides a task
    for (int t = warp; t < ny; t += WARPS) {
      const int y0 = t << 4;
      for (int e = lane; e < 16 * BS; e += 32) {
        const int kk = e >> 4, m = e & 15;
        wa[pofs<BS>(m, kk)] = zv(c0 + kk, y0 + m);
      }
      __syncwarp();
      wide_strip_solve<BS, true>(wa, Dk, Tk, lane);
      for (int e = lane; e < 16 * BS; e += 32) {
        const int kk = e >> 4, m = e & 15;
        if (c0 + kk < nb && y0 + m < R)
          Y[(c0 + kk) * R + y0 + m] = wa[pofs<BS>(m, kk)];
      }
      __syncwarp();
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    WIDE_MARK();
    // the rows above: Z_r -= L[c0.., r]^T X1
    if (k > 0)
      y_update(false, w16 >> 4, 0, c0, c0, [&](int q, int kb, double(&a)[4]) {
        const double* pa = P + (8 * kb + lc) * lds + 16 * q + lr;
        a[0] = pa[0];
        a[1] = pa[8];
        a[2] = pa[4 * lds];
        a[3] = pa[4 * lds + 8];
      });
    __syncthreads();
    WIDE_MARK();
  }
  if (fail) {
    for (int i = warp; i < nb; i += WARPS) {
      for (int j = lane; j < nb; j += 32) A[i * nb + j] = nan;
      for (int c = lane; c < R; c += 32) Y[i * R + c] = nan;
    }
  }
}

template <int BS>
__global__ void __launch_bounds__(THREADS) kron_pulsar_bwd_wide_kernel(
    const double* __restrict__ phi, const double* __restrict__ L,
    const double* __restrict__ X, const double* __restrict__ gchi,
    const double* __restrict__ gx, const double* __restrict__ gm,
    const double* __restrict__ gld, double* __restrict__ gphi,
    double* __restrict__ scratch, int nb, int m2, int ch) {
  constexpr int NT = BS / 8, G = WARPS / NT;
  extern __shared__ double smem[];
  WIDE_MARKS_BEGIN;
  const int R = m2 + 1;
  const int nbp = round16(nb), n16 = nbp >> 4, np = (nb + BS - 1) / BS;
  const int lds = 16 * ch + 4;
  double* Wp = smem;               // (nbp, BS), swizzled: W's column panel
  double* Sb = Wp + nbp * BS;      // (16, lds): a chunk of L's row strip
  double* Tb = Sb + 16 * lds;      // 2 x (16, 20): Tinv of the row block
  double* Pb = Tb + 2 * 320;       // WARPS x 128: the depth partials
  const int blk = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lr = lane >> 2, lc = lane & 3;
  const int t = warp % NT, g = warp / NT;  // column tile, depth group
  const double* Lb = L + (size_t)blk * nb * nb;
  const double* Xb = X + (size_t)blk * nb * R;
  const double* gmb = gm + (size_t)blk * m2 * m2;
  const double* gxb = gx + (size_t)blk * m2;
  double* gp = gphi + (size_t)blk * nb;
  double* Tg = scratch + (size_t)blk * wide_scratch_doubles(nb);
  const double gc = gchi[blk], gl = gld[blk];

  // s_k and q_k from T = X_uf gM^T, a warp per 8-row block (K5b's),
  // gchi x_u^2 + x_u q + s parked in gphi
  for (int rt = warp; rt < (round8(nb) >> 3); rt += WARPS) {
    const int row = (rt << 3) + lr;
    const bool vr = row < nb;
    const double* xrow = Xb + (vr ? row : 0) * R + 1;
    double s = 0.0, q = 0.0;
    for (int c0 = 0; c0 < m2; c0 += 8) {
      const int gi = c0 + lr;
      const double* grow = gmb + (gi < m2 ? gi : 0) * m2;
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
      q = q + (i0 < m2 ? gxb[i0] : 0.0) * x0;
      q = q + (i1 < m2 ? gxb[i1] : 0.0) * x1;
    }
    s = s + __shfl_xor_sync(FULL, s, 1);
    q = q + __shfl_xor_sync(FULL, q, 1);
    s = s + __shfl_xor_sync(FULL, s, 2);
    q = q + __shfl_xor_sync(FULL, q, 2);
    if (vr && lc == 0) {
      const double xu = xrow[-1];
      gp[row] = gc * (xu * xu) + xu * q + s;
    }
  }
  // the inverses of L's 16 x 16 diagonal blocks (identity-padded), a
  // half-warp each, lane c forming column c with the reciprocal of L_cc
  // from lane c (one division a lane)
  auto lv = [&](int i, int j) -> double {
    return i < nb && j < nb ? Lb[i * nb + j] : (i == j ? 1.0 : 0.0);
  };
  for (int Ib = 2 * warp; Ib < n16; Ib += 2 * WARPS) {
    const int I = Ib + (lane >> 4), c = lane & 15, i0 = I << 4;
    const double rme = 1.0 / lv(i0 + c, i0 + c);
    double x[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      double acc = i == c ? 1.0 : 0.0;
#pragma unroll
      for (int q = 0; q < i; ++q) {
        const double l = lv(i0 + i, i0 + q);
        if (q >= c) acc = acc - l * x[q];
      }
      const double ri = __shfl_sync(FULL, rme, (lane & 16) + i);
      x[i] = i < c ? 0.0 : acc * ri;
    }
    if (I < n16) {
#pragma unroll
      for (int i = 0; i < 16; ++i) Tg[I * 256 + i * 16 + c] = x[i];
    }
  }
  __syncthreads();
  WIDE_MARK();

  // the chunks in order: panel pp (columns pp BS..), row block I, chunk
  // h of its depth J in [I0, I), I0 = pp BS / 16; rb counts row blocks
  auto i0_of = [&](int pp) { return (pp * BS) >> 4; };
  auto nch_of = [&](int pp, int I) {
    const int nd = I - i0_of(pp);
    return nd == 0 ? 1 : (nd + ch - 1) / ch;
  };
  auto stage = [&](int pp, int I, int h, int tb) {
    const int jlo = i0_of(pp) + h * ch, jhi = min(jlo + ch, I);
    const int w = (jhi - jlo) << 4;
    for (int r = warp; r < 16; r += WARPS) {
      const int gi = (I << 4) + r;
      for (int c = lane; c < w; c += 32) {
        double* dst = Sb + r * lds + c;
        if (gi < nb) cp_async8(dst, Lb + gi * nb + (jlo << 4) + c);
        else *dst = 0.0;
      }
    }
    if (h + 1 == nch_of(pp, I))
      for (int e = tid; e < 256; e += THREADS)
        cp_async8(Tb + tb * 320 + (e >> 4) * 20 + (e & 15), Tg + I * 256 + e);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  int pp = 0, I = 0, h = 0, rb = 0;
  stage(0, 0, 0, 0);
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  double cs = 0.0;  // owner lanes 0..7: column pp BS + 8 t + lane's sum
  while (pp < np) {
    const int I0 = i0_of(pp), nd = I - I0;
    const bool last = h + 1 == nch_of(pp, I);
    const int jlo = I0 + h * ch, jhi = min(jlo + ch, I);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    WIDE_MARK();
    if (h == 0) acc[0] = acc[1] = acc[2] = acc[3] = 0.0;
    // this warp's depth blocks, J - I0 = g mod G, in ascending order
    for (int J = jlo + ((g - (jlo - I0)) & (G - 1)); J < jhi; J += G) {
      const double* a = Sb + ((J - jlo) << 4);
#pragma unroll
      for (int kb = 0; kb < 16; kb += 8)
        mma16(acc, a[lr * lds + kb + lc], a[(lr + 8) * lds + kb + lc],
              a[lr * lds + kb + lc + 4], a[(lr + 8) * lds + kb + lc + 4],
              Wp[pofs<BS>((J << 4) + kb + lc, 8 * t + lr)],
              Wp[pofs<BS>((J << 4) + kb + lc + 4, 8 * t + lr)]);
    }
    if (last && g > 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) Pb[warp * 128 + lane * 4 + e] = acc[e];
    }
    __syncthreads();
    WIDE_MARK();
    // the next chunk's loads fly while the owners combine this one
    int pn = pp, In = I, hn = h + 1, rbn = rb;
    if (last) {
      hn = 0;
      rbn = rb + 1;
      if (++In == n16) In = i0_of(++pn);
    }
    if (pn < np) stage(pn, In, hn, rbn & 1);
    WIDE_MARK();
    if (last && g == 0) {
      const int c0 = pp * BS, row0 = I << 4;
      const double* T = Tb + (rb & 1) * 320;
      // C = E - (the partials in warp order), then W_I = Tinv_I C
      double cv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        double s = acc[e];
        for (int gg = 1; gg < G; ++gg)
          s = s + Pb[(t + NT * gg) * 128 + lane * 4 + e];
        const int m = lr + 8 * (e >> 1), n = 2 * lc + (e & 1);
        cv[e] = (row0 + m == c0 + 8 * t + n ? 1.0 : 0.0) - s;
      }
      wide_store_d<BS>(Wp, row0 + lr, 8 * t + 2 * lc, cv);
      __syncwarp();
      double d[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int kb = 0; kb < 16; kb += 8)
        mma16(d, T[lr * 20 + kb + lc], T[(lr + 8) * 20 + kb + lc],
              T[lr * 20 + kb + lc + 4], T[(lr + 8) * 20 + kb + lc + 4],
              Wp[pofs<BS>(row0 + kb + lc, 8 * t + lr)],
              Wp[pofs<BS>(row0 + kb + lc + 4, 8 * t + lr)]);
      __syncwarp();
      wide_store_d<BS>(Wp, row0 + lr, 8 * t + 2 * lc, d);
      __syncwarp();
      if (lane < 8) {
        if (nd == 0) cs = 0.0;
        for (int r = 0; r < 16; ++r) {
          const double w = Wp[pofs<BS>(row0 + r, 8 * t + lane)];
          cs = cs + w * w;
        }
        const int k = c0 + 8 * t + lane;
        if (I + 1 == n16 && k < nb) {
          const double v = phi[(size_t)blk * nb + k];
          double gv = 0.0;
          if (v >= PHI_FLOOR) {
            const double br = gp[k] + gl * cs;
            gv = gl / v - br / (v * v);
          }
          gp[k] = gv;
        }
      }
    }
    WIDE_MARK();  // thread 0, an owner: its combine ends
    pp = pn;
    I = In;
    h = hn;
    rb = rbn;
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

template <int BS>
static int fwd_wide_launch(
    const double* phi, const double* g_uu, const double* g_uf,
    const double* g_ff, const double* b_u, const double* b_f,
    const double* rr, const double* ld_white, double* chi2, double* x_out,
    double* m_out, double* ld_out, double* L_out, double* X_out,
    double* scratch, int64_t n_blocks, int64_t n_psr, int64_t nb,
    int64_t m2, cudaStream_t stream) {
  const size_t bytes = sizeof(double) * wide_fwd_smem_doubles((int)nb, BS);
  int err = smem_limit((const void*)kron_pulsar_fwd_wide_kernel<BS>, bytes);
  if (err) return err;
  kron_pulsar_fwd_wide_kernel<BS><<<(unsigned)n_blocks, THREADS, bytes,
                                    stream>>>(
      phi, g_uu, g_uf, g_ff, b_u, b_f, rr, ld_white, chi2, x_out, m_out,
      ld_out, L_out, X_out, scratch, (int)n_psr, (int)nb, (int)m2);
  return (int)cudaGetLastError();
}

extern "C" int kron_pulsar_fwd_wide_launch(
    const double* phi, const double* g_uu, const double* g_uf,
    const double* g_ff, const double* b_u, const double* b_f,
    const double* rr, const double* ld_white, double* chi2, double* x_out,
    double* m_out, double* ld_out, double* L_out, double* X_out,
    double* scratch, int64_t n_blocks, int64_t n_psr, int64_t nb,
    int64_t m2, cudaStream_t stream) {
  const int lbs = wide_panel_log2(nb);
  if (lbs < 0 || m2 < 0 || m2 > (1 << 20)) return (int)cudaErrorInvalidValue;
#define FWD_WIDE_ARGS                                                       \
  phi, g_uu, g_uf, g_ff, b_u, b_f, rr, ld_white, chi2, x_out, m_out, ld_out, \
      L_out, X_out, scratch, n_blocks, n_psr, nb, m2, stream
  if (lbs == 5) return fwd_wide_launch<32>(FWD_WIDE_ARGS);
  if (lbs == 4) return fwd_wide_launch<16>(FWD_WIDE_ARGS);
  return fwd_wide_launch<8>(FWD_WIDE_ARGS);
#undef FWD_WIDE_ARGS
}

template <int BS>
static int bwd_wide_launch(const double* phi, const double* L,
                           const double* X, const double* gchi,
                           const double* gx, const double* gm,
                           const double* gld, double* gphi, double* scratch,
                           int64_t n_blocks, int64_t nb, int64_t m2,
                           cudaStream_t stream) {
  const int ch = wide_bwd_chunk((int)nb, BS);
  const size_t bytes = sizeof(double) * wide_bwd_smem_doubles((int)nb, BS, ch);
  int err = smem_limit((const void*)kron_pulsar_bwd_wide_kernel<BS>, bytes);
  if (err) return err;
  kron_pulsar_bwd_wide_kernel<BS><<<(unsigned)n_blocks, THREADS, bytes,
                                    stream>>>(
      phi, L, X, gchi, gx, gm, gld, gphi, scratch, (int)nb, (int)m2, ch);
  return (int)cudaGetLastError();
}

extern "C" int kron_pulsar_bwd_wide_launch(
    const double* phi, const double* L, const double* X, const double* gchi,
    const double* gx, const double* gm, const double* gld, double* gphi,
    double* scratch, int64_t n_blocks, int64_t nb, int64_t m2,
    cudaStream_t stream) {
  const int lbs = wide_panel_log2(nb);
  if (lbs < 0 || m2 < 0 || m2 > (1 << 20)) return (int)cudaErrorInvalidValue;
#define BWD_WIDE_ARGS \
  phi, L, X, gchi, gx, gm, gld, gphi, scratch, n_blocks, nb, m2, stream
  if (lbs == 5) return bwd_wide_launch<32>(BWD_WIDE_ARGS);
  if (lbs == 4) return bwd_wide_launch<16>(BWD_WIDE_ARGS);
  return bwd_wide_launch<8>(BWD_WIDE_ARGS);
#undef BWD_WIDE_ARGS
}

// the wide forms' panel width at nb (0: too wide for either)
extern "C" int kron_pulsar_wide_panel(int64_t nb) {
  const int lbs = wide_panel_log2(nb);
  return lbs < 0 ? 0 : 1 << lbs;
}

// the scratch doubles a block of either wide form needs at nb
extern "C" int kron_pulsar_wide_scratch(int64_t nb) {
  return wide_panel_log2(nb) < 0 ? 0 : wide_scratch_doubles((int)nb);
}

// shared bytes of a K5w (backward 0) or K5bw (1) block at nb, 0 where
// nb is too wide
extern "C" int kron_pulsar_wide_smem(int64_t nb, int64_t backward) {
  const int lbs = wide_panel_log2(nb);
  if (lbs < 0) return 0;
  const int bs = 1 << lbs;
  return (int)(8 * (backward ? wide_bwd_smem_doubles(
                                   (int)nb, bs, wide_bwd_chunk((int)nb, bs))
                             : wide_fwd_smem_doubles((int)nb, bs)));
}

// K5w (backward 0) or K5bw (1) blocks that fit on one SM at nb
extern "C" int kron_pulsar_wide_occupancy(int64_t nb, int64_t backward) {
  const int lbs = wide_panel_log2(nb);
  if (lbs < 0) return 0;
  const void* fns[2][3] = {
      {(const void*)kron_pulsar_fwd_wide_kernel<8>,
       (const void*)kron_pulsar_fwd_wide_kernel<16>,
       (const void*)kron_pulsar_fwd_wide_kernel<32>},
      {(const void*)kron_pulsar_bwd_wide_kernel<8>,
       (const void*)kron_pulsar_bwd_wide_kernel<16>,
       (const void*)kron_pulsar_bwd_wide_kernel<32>}};
  const void* fn = fns[backward ? 1 : 0][lbs - 3];
  const size_t bytes = (size_t)kron_pulsar_wide_smem(nb, backward);
  int err = smem_limit(fn, bytes);
  if (err) return -err;
  int n = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, THREADS,
                                                           bytes);
  return err ? -err : n;
}

#ifdef WIDE_MARKS
// the marks of the launches since the last read, then cleared
extern "C" int wide_marks_read(long long* t, int* l) {
  cudaMemcpyFromSymbol(t, wide_mark_t, sizeof(wide_mark_t));
  int err = (int)cudaMemcpyFromSymbol(l, wide_mark_l, sizeof(wide_mark_l));
  void* p = nullptr;
  cudaGetSymbolAddress(&p, wide_mark_l);
  return err ? err : (int)cudaMemset(p, 0, sizeof(wide_mark_l));
}
#endif
