// Kernel K3: the ragged per-pulsar weighted gram of the kron-structured
// PTA likelihood and the optimal statistic's whitening.
//
// Replaces pint_tpu/linalg.py:605 kron_gram_precompute (the einsums
// "pni,pn,pnj->pij" over padded per-pulsar stacks), which
// gw/common.py:_kron_lnlike_one and gw/os.py:_zm_one reach.
//
// For each pulsar a, over its own rows only, with w = 1/sigma^2 and
// T_a = [U_a | F_a | r_a] (n_a rows, nb_a + m2 + 1 columns):
//
//   gram[a] = T_a^T diag(w) T_a        (g_uu, g_uf, g_ff, b_u, b_f, rr)
//   ld_white[a] = sum_n log(sigma_n^2)
//
// Layout: T is ragged in rows and in U's width.  Pulsar a's block is
// row-major (n_a, w_a) at element t_off[a]; its sigmas are
// sigma[row_off[a] .. row_off[a+1]).  The output is padded to the
// widest pulsar: gram (P, Wp, Wp) with Wp = nb_max + m2 + 1, pulsar
// column c placed at c (U) or c + nb_max - nb_a (F, r).  The wrapper
// zero-fills it, so pad entries are exact zeros, as the reference's
// zero pad rows and columns give.
//
// Order: every output entry (i <= j) is owned by one thread, which adds
// the row products (T[n,i] w[n]) T[n,j] in ascending n from 0.0; the
// (j, i) entry is the same number.  The result is bit-identical from
// run to run (no atomics), and ld_white is a fixed-order block
// reduction.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp64 on the tensor
// cores, the peak for this GEMM-shaped work): at P = 68, 500 rows,
// width 92 the function moves 30 MB (~9 us) and does ~0.3 GFLOP of the
// symmetric half (~4.4 us), so bytes bound it.  At 10^4 rows per pulsar
// (0.5 GB) it is ~0.15 ms of bytes and ~0.09 ms of operations.  The
// design: one block per (pulsar,
// 32 x 32 tile of the upper triangle), plus one block per pulsar for
// ld_white.  The block stages 32 rows of its two column strips in
// shared memory (the i strip already weighted), and each of its 256
// threads accumulates a 2 x 2 group of entries from shared memory.
// A row chunk is read once per tile pair, so T is read ~Wp/32 times,
// mostly from L2.  No tensor cores, nothing allocated.

#include <cstdint>
#include <cuda_runtime.h>

#define TILE 32
#define HALF 16
#define ROWS 32
#define THREADS 256

__global__ void kron_gram_kernel(const double* __restrict__ t,
                                 const double* __restrict__ sigma,
                                 const int64_t* __restrict__ row_off,
                                 const int64_t* __restrict__ t_off,
                                 const int32_t* __restrict__ nb,
                                 double* __restrict__ gram,
                                 double* __restrict__ ld_white,
                                 int64_t nb_max, int64_t m2,
                                 int64_t n_tiles) {
  const int64_t a = blockIdx.x;
  const int64_t r0 = row_off[a];
  const int64_t n = row_off[a + 1] - r0;
  const int64_t nba = nb[a];
  const int64_t w = nba + m2 + 1;
  const int64_t wp = nb_max + m2 + 1;
  const int tid = threadIdx.x;
  const int64_t n_pairs = n_tiles * (n_tiles + 1) / 2;

  if ((int64_t)blockIdx.y == n_pairs) {
    __shared__ double red[THREADS];
    double acc = 0.0;
    for (int64_t k = tid; k < n; k += THREADS) {
      const double s = sigma[r0 + k];
      acc = __dadd_rn(acc, log(__dmul_rn(s, s)));
    }
    red[tid] = acc;
    __syncthreads();
    for (int s = THREADS / 2; s > 0; s >>= 1) {
      if (tid < s) red[tid] = __dadd_rn(red[tid], red[tid + s]);
      __syncthreads();
    }
    if (tid == 0) ld_white[a] = red[0];
    return;
  }

  // tile pair (bi, bj), bi <= bj, from the block's linear index
  int64_t p = blockIdx.y, bi = 0;
  while (p >= n_tiles - bi) {
    p -= n_tiles - bi;
    ++bi;
  }
  const int64_t bj = bi + p;
  const int64_t i0 = bi * TILE, j0 = bj * TILE;
  if (j0 >= w) return;  // the whole tile lies past this pulsar's width

  __shared__ double sw[ROWS];
  __shared__ double si[ROWS][TILE];  // T[:, i0 + c] * w
  __shared__ double sj[ROWS][TILE];  // T[:, j0 + c]
  const int tx = tid % HALF, ty = tid / HALF;
  double acc00 = 0.0, acc01 = 0.0, acc10 = 0.0, acc11 = 0.0;
  const double* ta = t + t_off[a];
  for (int64_t c0 = 0; c0 < n; c0 += ROWS) {
    if (tid < ROWS) {
      const int64_t row = c0 + tid;
      double wr = 0.0;
      if (row < n) {
        const double s = sigma[r0 + row];
        wr = __ddiv_rn(1.0, __dmul_rn(s, s));
      }
      sw[tid] = wr;
    }
    __syncthreads();
    for (int e = tid; e < ROWS * TILE; e += THREADS) {
      const int r = e / TILE, c = e % TILE;
      const int64_t row = c0 + r;
      double vi = 0.0, vj = 0.0;
      if (row < n) {
        if (i0 + c < w) vi = __dmul_rn(ta[row * w + i0 + c], sw[r]);
        if (j0 + c < w) vj = ta[row * w + j0 + c];
      }
      si[r][c] = vi;
      sj[r][c] = vj;
    }
    __syncthreads();
    const int rmax = (int)((n - c0) < ROWS ? (n - c0) : ROWS);
    for (int r = 0; r < rmax; ++r) {
      const double a0 = si[r][ty], a1 = si[r][ty + HALF];
      const double b0 = sj[r][tx], b1 = sj[r][tx + HALF];
      acc00 = __dadd_rn(acc00, __dmul_rn(a0, b0));
      acc01 = __dadd_rn(acc01, __dmul_rn(a0, b1));
      acc10 = __dadd_rn(acc10, __dmul_rn(a1, b0));
      acc11 = __dadd_rn(acc11, __dmul_rn(a1, b1));
    }
    __syncthreads();
  }

  const double accs[2][2] = {{acc00, acc01}, {acc10, acc11}};
  double* ga = gram + a * wp * wp;
  for (int di = 0; di < 2; ++di) {
    for (int dj = 0; dj < 2; ++dj) {
      const int64_t i = i0 + ty + di * HALF;
      const int64_t j = j0 + tx + dj * HALF;
      if (i < w && j < w && i <= j) {
        const int64_t pi = i + (i >= nba ? nb_max - nba : 0);
        const int64_t pj = j + (j >= nba ? nb_max - nba : 0);
        ga[pi * wp + pj] = accs[di][dj];
        ga[pj * wp + pi] = accs[di][dj];
      }
    }
  }
}

extern "C" int kron_gram_launch(const void* t, const void* sigma,
                                const void* row_off, const void* t_off,
                                const void* nb, void* gram, void* ld_white,
                                int64_t n_psr, int64_t nb_max, int64_t m2,
                                void* stream) {
  const int64_t wp = nb_max + m2 + 1;
  const int64_t n_tiles = (wp + TILE - 1) / TILE;
  const dim3 grid((unsigned)n_psr,
                  (unsigned)(n_tiles * (n_tiles + 1) / 2 + 1));
  kron_gram_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const double*)t, (const double*)sigma, (const int64_t*)row_off,
      (const int64_t*)t_off, (const int32_t*)nb, (double*)gram,
      (double*)ld_white, nb_max, m2, n_tiles);
  return (int)cudaGetLastError();
}
