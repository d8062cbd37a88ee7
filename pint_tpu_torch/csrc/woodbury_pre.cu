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
// lt = L^T (row k of lt is column k of L).  The epoch block is the
// structured basis' CSR (perm, offsets: each epoch's rows in ascending
// order); rows outside every epoch are absent from perm.  The
// reference densifies U; here the indicator columns cost one add per
// row in an epoch.
//
// The work is GEMM- and TRSM-shaped across points, so the kernel
// batches points instead of looping over them.  Three kernels, one
// launcher call:
//
// 1. woodbury_rhs_kernel, one block per (row split, tile of 32 points,
//    64 dense columns).  A split is rs consecutive rows, a multiple of
//    32 set by the shape alone (split_rows, which the caller reads
//    through woodbury_chi2_pre_plan), so the bits do not depend on the
//    card; it keeps the blocks to one wave, two on each SM.  The block stages 32 rows at a time: y =
//    r / n for its 32 points (each thread a row and 4 points, adding r y
//    to its own running sum of s = sum r^2/n) and the rows' dense
//    columns, then multiplies U_d^T Y on the fp64 tensor cores
//    (mma.sync m16n8k8; 8 warps, each 16 columns x 16 points, even and
//    odd k steps in separate chains).  It writes its split's partials
//    of s and of the dense entries of b = U^T N^-1 r.  The blocks of the
//    first column group also form the epoch entries of b whole: epochs
//    are dealt to the splits in even runs, one thread per (epoch, point)
//    adds y over the epoch's rows in ascending order, 8 rows' loads at
//    once.  So U_d and the CSR are read once per tile of 32 points.  np
//    more blocks invert the diagonal 32 x 32 blocks of L (one lane a
//    column, forward substitution with the diagonal's reciprocals) for
//    stage 3.  Loads go out at clamped, valid addresses, all before the
//    first store to shared memory, so that they are in flight together.
// 2. woodbury_reduce_kernel, one block per 32 consecutive partial
//    entries: the split partials are staged by cp.async (each warp a
//    split, each lane an entry: coalesced, in two groups) and warp 0
//    adds them in ascending split order.  Out come s and the dense
//    entries of b, in b's place for stage 3.
// 3. woodbury_solve_kernel, one block per 8 points: z = L^-1 b by
//    blocked left-looking substitution over panels of 32 rows.  For
//    panel p the 8 warps share the products L_pj z_j, j < p (warp w
//    takes j = w, w + 8, ...; m16n8k8 on the fp64 tensor cores; L read
//    from device memory once per block, each warp's first j a panel
//    ahead; z in shared memory up to K8_ZCAP panels, past that in the
//    scratch), their sums are added in ascending warp order and
//    subtracted from b_p, and z_p = D_p^-1 (b_p - ...) is one more
//    product with the inverted diagonal block (staged a panel ahead):
//    no row-by-row chain.  Each warp then sums one point's z^2, a panel
//    at a time by a fixed shuffle tree, the panels in ascending order:
//    chi2_g = s_g - sum_k z_kg^2.
// Stages 2 and 3 are programmatic dependent launches: each one's launch
// overlaps the end of the one before, and griddepcontrol.wait holds its
// reads until that one is done.  Every sum has one owner and a fixed
// order, no atomics: the result is bit-identical from run to run.
// -fmad=false keeps the scalar products separately rounded; the MMA
// rounds its own 8-term sums.  A NaN factor (a failed factorization)
// gives NaN, as the reference does.  There is no limit on K: L is read
// by panels and z spills from shared memory to the scratch.
//
// Bound on an H100 (3.35 TB/s; fp64 67 TFLOP/s on the tensor cores for
// the GEMM/TRSM-shaped dense product and substitution, 34 for the
// elementwise rest), at the grid's shape (G = 256, N = 10^4, 61 dense
// columns, 400 epochs, K = 461): ~1.46 MFLOP per point (2 N per dense
// column, K^2 for the substitution), ~0.006 ms, against ~26 MB of
// bytes (R once, n, the dense columns, the CSR and L's lower triangle
// once, all that is read of it), 0.008 ms: the bytes bound it.  What is left above that: stage 3's 15 dependent
// panels, each a few barriers and L2 round trips, on one SM per 8
// points, and stage 1's latency per staged chunk.

#include <cstdint>
#include <cuda_runtime.h>

#define K8_THREADS 256
#define K8_WARPS (K8_THREADS / 32)
#define K8_GA 32   // points per tile of stage 1
#define K8_GB 8    // points per block of stage 3
#define K8_ROWS 32 // rows per staged chunk; the panel height of stage 3
#define K8_COLS 64 // dense columns per block of stage 1
#define K8_LDU (K8_COLS + 8)  // = 8 mod 16 doubles: conflict-free A loads
#define K8_LDY (K8_ROWS + 4)  // = 4 mod 16 doubles: conflict-free B loads
#define K8_RT 32   // partial entries per reduce block
#define K8_RS 512  // splits staged per pass of the reduce (128 kB)
#define K8_ZCAP 64 // panels of z the substitution keeps in shared memory
#define K8_BLOCKS 264  // stage 1's target: two blocks on each of 132 SMs

__device__ __forceinline__ void mma16(double (&d)[4], double a0, double a1,
                                      double a2, double a3, double b0,
                                      double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

// The shape every stage derives from (g, n, k_pre, k_e, k_post, rs).
struct K8Shape {
  int64_t g, n, k_pre, k_e, k_post, rs;
  int64_t k, kd, kpad, np, nc, kdp, tiles_a, gp, tiles_b, ns;
  __host__ __device__ K8Shape(int64_t g_, int64_t n_, int64_t kp,
                              int64_t ke, int64_t kq, int64_t rs_)
      : g(g_), n(n_), k_pre(kp), k_e(ke), k_post(kq), rs(rs_) {
    k = kp + ke + kq;
    kd = kp + kq;
    kpad = (k + K8_ROWS - 1) / K8_ROWS * K8_ROWS;
    np = kpad / K8_ROWS;
    nc = kd > 0 ? (kd + K8_COLS - 1) / K8_COLS : 1;
    kdp = nc * K8_COLS;
    tiles_a = (g + K8_GA - 1) / K8_GA;
    gp = tiles_a * K8_GA;
    tiles_b = (g + K8_GB - 1) / K8_GB;
    ns = (n + rs - 1) / rs;
  }
  // scratch, in doubles: dpart (ns, 1 + kdp, gp): column 0 the partials
  // of s, column 1 + c those of dense column c; bz (tiles_b, kpad, 8):
  // b, then z; dinv (np, 32, 32); s (gp)
  __host__ __device__ int64_t dpart_len() const {
    return ns * (1 + kdp) * gp;
  }
  __host__ __device__ int64_t bz_len() const { return tiles_b * kpad * K8_GB; }
  __host__ __device__ int64_t dinv_len() const {
    return np * K8_ROWS * K8_ROWS;
  }
  __host__ __device__ int64_t scratch_len() const {
    return dpart_len() + bz_len() + dinv_len() + gp;
  }
};

// D_p^-1 for the diagonal block p of L (rows past K: the identity), one
// lane a column, by forward substitution from shared memory, with the
// diagonal's reciprocals formed first (one division per lane, at once)
__device__ void diag_inverse(const double* __restrict__ lt,
                             double* __restrict__ dinv, int64_t k,
                             int64_t p, double* d) {
  const int t = threadIdx.x;
  const int64_t r0 = p * K8_ROWS;
  double* rd = d + K8_ROWS * (K8_ROWS + 1);  // 1 / D_cc
  for (int idx = t; idx < K8_ROWS * K8_ROWS; idx += K8_THREADS) {
    const int i = idx & 31;  // row: consecutive threads, consecutive lt
    const int j = idx >> 5;
    const int64_t gi = r0 + i, gj = r0 + j;
    double v;
    if (gi < k && gj < k)
      v = j <= i ? lt[gj * k + gi] : 0.0;
    else
      v = i == j ? 1.0 : 0.0;
    d[i * (K8_ROWS + 1) + j] = v;
  }
  __syncthreads();
  if (t >= 32) return;
  rd[t] = 1.0 / d[t * (K8_ROWS + 1) + t];
  __syncwarp();
  double x[K8_ROWS];
#pragma unroll
  for (int i = 0; i < K8_ROWS; ++i) x[i] = i == t ? 1.0 : 0.0;
#pragma unroll
  for (int c = 0; c < K8_ROWS; ++c) {
    x[c] = __dmul_rn(x[c], rd[c]);
#pragma unroll
    for (int i = c + 1; i < K8_ROWS; ++i)
      x[i] = __dsub_rn(x[i], __dmul_rn(d[i * (K8_ROWS + 1) + c], x[c]));
  }
  double* out = dinv + p * K8_ROWS * K8_ROWS;
#pragma unroll
  for (int i = 0; i < K8_ROWS; ++i) out[i * K8_ROWS + t] = x[i];
}

__global__ void __launch_bounds__(K8_THREADS)
woodbury_rhs_kernel(const double* __restrict__ r,
                    const double* __restrict__ nvec,
                    const double* __restrict__ pre,
                    const int32_t* __restrict__ perm,
                    const int32_t* __restrict__ offsets,
                    const double* __restrict__ post,
                    const double* __restrict__ lt, double* __restrict__ dpart,
                    double* __restrict__ bz, double* __restrict__ dinv,
                    int64_t g, int64_t n, int64_t k_pre, int64_t k_e,
                    int64_t k_post, int64_t rs) {
  __shared__ double ud[K8_ROWS][K8_LDU];  // the chunk's dense columns
  __shared__ double ys[K8_GA][K8_LDY];    // y = r / n, point-major
  const K8Shape sh(g, n, k_pre, k_e, k_post, rs);
  int64_t b = blockIdx.x;
  if (b < sh.np) {
    diag_inverse(lt, dinv, sh.k, b, &ud[0][0]);
    return;
  }
  b -= sh.np;
  const int64_t cg0 = (b % sh.nc) * K8_COLS;
  b /= sh.nc;
  const int64_t tile = b % sh.tiles_a;
  const int64_t split = b / sh.tiles_a;
  const bool first = cg0 == 0;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int gq = lane >> 2, tig = lane & 3;
  const int mt = warp & 3;         // 16 dense columns
  const int nt0 = 2 * (warp >> 2); // two 8-point tiles
  const int64_t g0 = tile * K8_GA;
  const int64_t row_begin = split * rs;
  const int64_t row_end = row_begin + rs < n ? row_begin + rs : n;
  const int64_t kd = sh.kd;

  // [point tile][even / odd k step]: four independent MMA chains
  double acc[2][2][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      acc[u][e][0] = acc[u][e][1] = acc[u][e][2] = acc[u][e][3] = 0.0;
  double sacc[4] = {0.0, 0.0, 0.0, 0.0};

  for (int64_t i0 = row_begin; i0 < row_end; i0 += K8_ROWS) {
    // y for row i0 + lane and points warp + 8 q
    // every load at a clamped, valid address and all of them before
    // the first store to shared memory, so they are in flight together;
    // the pad entries are zeroed after
    const int64_t i = i0 + lane;
    const bool rowok = i < row_end;
    const int64_t ic = rowok ? i : row_begin;
    const double nv = __ldg(nvec + ic);
    double rv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t gg = g0 + warp + 8 * q;
      rv[q] = __ldg(r + (gg < g ? gg : g - 1) * n + ic);
    }
    constexpr int UD = K8_ROWS * K8_COLS / K8_THREADS;
    double uv[UD];
    if (kd > 0) {
#pragma unroll
      for (int u = 0; u < UD; ++u) {
        const int idx = t + K8_THREADS * u;
        const int64_t ii = i0 + idx / K8_COLS < row_end ? i0 + idx / K8_COLS
                                                        : row_begin;
        const int64_t c = cg0 + idx % K8_COLS;
        const double* src = c < k_pre ? pre + ii * k_pre + c
                             : c < kd ? post + ii * k_post + (c - k_pre)
                                      : nvec;
        uv[u] = __ldg(src);
      }
#pragma unroll
      for (int u = 0; u < UD; ++u) {
        const int idx = t + K8_THREADS * u;
        const int rr = idx / K8_COLS, col = idx % K8_COLS;
        ud[rr][col] = i0 + rr < row_end && cg0 + col < kd ? uv[u] : 0.0;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool ok = rowok && g0 + warp + 8 * q < g;
      const double v = ok ? rv[q] / nv : 0.0;
      if (first && ok) sacc[q] = __dadd_rn(sacc[q], __dmul_rn(rv[q], v));
      ys[warp + 8 * q][lane] = v;
    }
    __syncthreads();
    if (kd > 0) {
#pragma unroll
      for (int kk = 0; kk < K8_ROWS; kk += 8) {
        const double a0 = ud[kk + tig][16 * mt + gq];
        const double a1 = ud[kk + tig][16 * mt + gq + 8];
        const double a2 = ud[kk + tig + 4][16 * mt + gq];
        const double a3 = ud[kk + tig + 4][16 * mt + gq + 8];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int pt = 8 * (nt0 + u) + gq;
          mma16(acc[u][(kk >> 3) & 1], a0, a1, a2, a3, ys[pt][kk + tig],
                ys[pt][kk + tig + 4]);
        }
      }
    }
    __syncthreads();
  }

  double* dp = dpart + split * (1 + sh.kdp) * sh.gp;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int64_t c = cg0 + 16 * mt + gq;  // rows gq and gq + 8 of C
    const int64_t pt = g0 + 8 * (nt0 + u) + 2 * tig;
    double sum[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[e] = __dadd_rn(acc[u][0][e], acc[u][1][e]);
    *reinterpret_cast<double2*>(dp + (1 + c) * sh.gp + pt) =
        make_double2(sum[0], sum[1]);
    *reinterpret_cast<double2*>(dp + (1 + c + 8) * sh.gp + pt) =
        make_double2(sum[2], sum[3]);
  }
  if (!first) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    double v = sacc[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = __dadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
    if (lane == 0) dp[g0 + warp + 8 * q] = v;
  }
  // the split's run of epochs, whole: warp w epochs w, w + 8, ..., lane
  // a point
  const int64_t e_lo = split * k_e / sh.ns;
  const int64_t e_hi = (split + 1) * k_e / sh.ns;
  const int64_t gg = g0 + lane;
  if (gg >= sh.tiles_b * K8_GB) return;
  const double* rg = r + (gg < g ? gg : g - 1) * n;
  for (int64_t e = e_lo + warp; e < e_hi; e += K8_WARPS) {
    double a = 0.0;
    if (gg < g) {
      int32_t q = offsets[e];
      const int32_t q1 = offsets[e + 1];
      // 8 rows' loads at once, then their quotients, then their adds in
      // ascending order; the next 8 rows' indices load meanwhile
      int32_t ii[8], in[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) in[u] = q + 8 <= q1 ? __ldg(perm + q + u) : 0;
      for (; q + 8 <= q1; q += 8) {
        double rv[8], nv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) ii[u] = in[u];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          in[u] = q + 16 <= q1 ? __ldg(perm + q + 8 + u) : 0;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          rv[u] = __ldg(rg + ii[u]);
          nv[u] = __ldg(nvec + ii[u]);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) rv[u] = rv[u] / nv[u];
#pragma unroll
        for (int u = 0; u < 8; ++u) a = __dadd_rn(a, rv[u]);
      }
      for (; q < q1; ++q) {
        const int64_t ii = perm[q];
        a = __dadd_rn(a, rg[ii] / nvec[ii]);
      }
    }
    bz[((gg / K8_GB) * sh.kpad + k_pre + e) * K8_GB + gg % K8_GB] = a;
  }
}

// acc + col[lo K8_RT] + ... + col[(hi - 1) K8_RT], in ascending order,
// the shared loads one group of 8 ahead of the chain of adds
__device__ __forceinline__ double sum_column(double acc, const double* col,
                                             int lo, int hi) {
  double nx[8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
    nx[u] = lo + u < hi ? col[(lo + u) * K8_RT] : 0.0;
  for (int q = lo; q < hi; q += 8) {
    double v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      v[u] = nx[u];
      nx[u] = q + 8 + u < hi ? col[(q + 8 + u) * K8_RT] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (q + u < hi) acc = __dadd_rn(acc, v[u]);
  }
  return acc;
}

// the reduce's shared memory: the partials of one pass
static size_t reduce_smem(int64_t ns) {
  return sizeof(double) * K8_RT * (size_t)(ns < K8_RS ? ns : K8_RS);
}

__global__ void __launch_bounds__(K8_THREADS)
woodbury_reduce_kernel(const double* __restrict__ dpart,
                       double* __restrict__ bz, double* __restrict__ s_out,
                       int64_t g, int64_t n, int64_t k_pre, int64_t k_e,
                       int64_t k_post, int64_t rs) {
  extern __shared__ double st[];  // [split][K8_RT]
  const K8Shape sh(g, n, k_pre, k_e, k_post, rs);
  const int64_t total = (1 + sh.kd) * sh.gp;  // the entries that matter
  const int64_t stride = (1 + sh.kdp) * sh.gp; // one split's partials
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int64_t e = (int64_t)blockIdx.x * K8_RT + lane;
  const bool live = e < total;
  const double* col = st + lane;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // stage 1 is done
  double acc = 0.0;
  for (int64_t s0 = 0; s0 < sh.ns; s0 += K8_RS) {
    const int cnt = sh.ns - s0 < K8_RS ? (int)(sh.ns - s0) : K8_RS;
    const int half = cnt / 2;
    // two groups of copies: the first half is summed while the second
    // lands
    for (int h = 0; h < 2; ++h) {
      const int lo = h ? half : 0, hi = h ? cnt : half;
      if (live)
        for (int rr = lo + warp; rr < hi; rr += K8_WARPS)
          cp_async8(&st[rr * K8_RT + lane], dpart + (s0 + rr) * stride + e);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    for (int h = 0; h < 2; ++h) {
      if (h == 0)
        asm volatile("cp.async.wait_group 1;\n" ::);
      else
        asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();
      if (warp == 0 && live) {
        int rr = h ? half : 0;
        const int hi = h ? cnt : half;
        if (s0 == 0 && rr == 0 && rr < hi) {
          acc = col[0];
          rr = 1;
        }
        acc = sum_column(acc, col, rr, hi);
      }
    }
    __syncthreads();
  }
  if (warp != 0 || !live) return;
  const int64_t c = e / sh.gp - 1;  // -1: s
  const int64_t pt = e % sh.gp;
  if (c < 0) {
    s_out[pt] = acc;
    return;
  }
  const int64_t row = c < k_pre ? c : c + k_e;
  if (pt < sh.tiles_b * K8_GB)
    bz[((pt / K8_GB) * sh.kpad + row) * K8_GB + pt % K8_GB] = acc;
}

// shared memory of the substitution: the panels of z it keeps
static size_t solve_smem(int64_t np) {
  return sizeof(double) * K8_ROWS * K8_GB *
         (size_t)(np < K8_ZCAP ? np : K8_ZCAP);
}

__global__ void __launch_bounds__(K8_THREADS, 1)
woodbury_solve_kernel(const double* __restrict__ lt,
                      const double* __restrict__ dinv, double* bz,
                      const double* __restrict__ s_in,
                      double* __restrict__ chi2, int64_t g, int64_t k) {
  extern __shared__ double zsh[];  // z of panels < K8_ZCAP, [row][point]
  __shared__ double part[K8_WARPS][K8_ROWS][K8_GB];
  __shared__ double dsh[2][K8_ROWS][K8_LDY];  // D_p^-1, one panel ahead
  __shared__ double accs[K8_ROWS][K8_GB];
  const int64_t kpad = (k + K8_ROWS - 1) / K8_ROWS * K8_ROWS;
  const int64_t np = kpad / K8_ROWS;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int gq = lane >> 2, tig = lane & 3;
  const int m = t >> 3, nn = t & 7;  // the combine's entry
  double* bt = bz + (int64_t)blockIdx.x * kpad * K8_GB;  // b; z past ZCAP
  // L_pj's fragments for the warp's first j (j = warp), loaded one panel
  // ahead: [k step][rows 0-15 a0-a3, 16-31 a0-a3]
  double pf[4][8];
  // fragments of L[r0 + gq + 0, 8, 16, 24][j 32 + 8 ks + tig (+ 4)]: the
  // columns are below r0, the rows clamped to K - 1 and zeroed after
  auto load_l = [&](double (&f)[4][8], int64_t r0, int64_t j) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int64_t ca = j * K8_ROWS + 8 * ks + tig;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        // e: rows + 0, 8 (columns ca, ca + 4 as a2, a3), then + 16, 24
        const int64_t row = r0 + gq + 8 * (e & 1) + 16 * (e >> 2);
        const int64_t col = ca + 4 * ((e >> 1) & 1);
        const double v = lt[col * k + (row < k ? row : k - 1)];
        f[ks][e] = row < k ? v : 0.0;
      }
    }
  };
  // c[e][0] (rows 0-15), c[e][1] (rows 16-31) += L_pj z_j over the
  // even (e = 0) and odd k steps, z_j at zj: four independent chains
  auto product = [&](double (&c)[2][2][4], const double (&f)[4][8],
                     const double* zj) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int kc = 8 * ks + tig;
      const double b0 = zj[kc * K8_GB + gq];
      const double b1 = zj[(kc + 4) * K8_GB + gq];
      mma16(c[ks & 1][0], f[ks][0], f[ks][1], f[ks][2], f[ks][3], b0, b1);
      mma16(c[ks & 1][1], f[ks][4], f[ks][5], f[ks][6], f[ks][7], b0, b1);
    }
  };
  auto product_j = [&](double (&c)[2][2][4], const double (&f)[4][8],
                       int64_t j) {
    if (j < K8_ZCAP)
      product(c, f, zsh + j * K8_ROWS * K8_GB);
    else
      product(c, f, bt + j * K8_ROWS * K8_GB);
  };
  auto stage_dinv = [&](int64_t p) {
    for (int idx = t; idx < K8_ROWS * K8_ROWS; idx += K8_THREADS)
      cp_async8(&dsh[p & 1][idx / K8_ROWS][idx % K8_ROWS],
                dinv + p * K8_ROWS * K8_ROWS + idx);
  };
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the reduce is done
  if (np > 0) stage_dinv(0);
  asm volatile("cp.async.commit_group;\n" ::);
  double bv = m < k ? bt[m * K8_GB + nn] : 0.0;  // b_0's entry
  for (int64_t p = 0; p < np; ++p) {
    const int64_t r0 = p * K8_ROWS;
    // the next panel's D^-1 and b entry, in flight during this panel
    if (p + 1 < np) stage_dinv(p + 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const double bv_next = p + 1 < np && r0 + K8_ROWS + m < k
                               ? bt[(r0 + K8_ROWS + m) * K8_GB + nn]
                               : 0.0;
    double c[2][2][4];  // [even / odd k step][rows 0-15 / 16-31]
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        c[e][h][0] = c[e][h][1] = c[e][h][2] = c[e][h][3] = 0.0;
    if (warp < p) product_j(c, pf, warp);
    for (int64_t j = warp + K8_WARPS; j < p; j += K8_WARPS) {
      double f[4][8];
      load_l(f, r0, j);
      product_j(c, f, j);
    }
    // the next panel's first j, in flight until its products
    if (warp < p + 1 && p + 1 < np) load_l(pf, r0 + K8_ROWS, warp);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ra = 16 * h + gq;
      part[warp][ra][2 * tig] = __dadd_rn(c[0][h][0], c[1][h][0]);
      part[warp][ra][2 * tig + 1] = __dadd_rn(c[0][h][1], c[1][h][1]);
      part[warp][ra + 8][2 * tig] = __dadd_rn(c[0][h][2], c[1][h][2]);
      part[warp][ra + 8][2 * tig + 1] = __dadd_rn(c[0][h][3], c[1][h][3]);
    }
    asm volatile("cp.async.wait_group 1;\n" ::);  // D_p^-1 landed
    __syncthreads();
    {
      const int64_t nw = p < K8_WARPS ? p : K8_WARPS;  // warps with a j
      double s = 0.0;
      for (int w = 0; w < nw; ++w)
        s = w == 0 ? part[0][m][nn] : __dadd_rn(s, part[w][m][nn]);
      accs[m][nn] = nw > 0 ? __dsub_rn(bv, s) : bv;
    }
    __syncthreads();
    // warps 0 and 1: rows 0-15 and 16-31 of z_p = D_p^-1 acc
    if (warp < 2) {
      double dd[2][4] = {{0.0, 0.0, 0.0, 0.0}, {0.0, 0.0, 0.0, 0.0}};
      const int ra0 = 16 * warp + gq, rb0 = ra0 + 8;
      const int b = p & 1;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // even and odd k steps apart
        const int kc = 8 * ks + tig;
        mma16(dd[ks & 1], dsh[b][ra0][kc], dsh[b][rb0][kc],
              dsh[b][ra0][kc + 4], dsh[b][rb0][kc + 4], accs[kc][gq],
              accs[kc + 4][gq]);
      }
      double d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = __dadd_rn(dd[0][e], dd[1][e]);
      const double2 za = make_double2(d[0], d[1]);
      const double2 zb = make_double2(d[2], d[3]);
      if (p < K8_ZCAP) {
        double* zp = zsh + r0 * K8_GB;
        *reinterpret_cast<double2*>(zp + ra0 * K8_GB + 2 * tig) = za;
        *reinterpret_cast<double2*>(zp + rb0 * K8_GB + 2 * tig) = zb;
      } else {
        double* zp = bt + r0 * K8_GB;
        *reinterpret_cast<double2*>(zp + ra0 * K8_GB + 2 * tig) = za;
        *reinterpret_cast<double2*>(zp + rb0 * K8_GB + 2 * tig) = zb;
      }
    }
    __syncthreads();
    bv = bv_next;
  }
  // point `warp`'s sum of z^2: each panel's 32 squares by a fixed
  // shuffle tree (4 panels' trees at once), the panels in ascending order
  double tot = 0.0;
  auto squares = [&](const double* z, int64_t p0, int64_t p1) {
    for (; p0 < p1; p0 += 4) {
      double v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const double x = p0 + u < p1
            ? z[(p0 + u) * K8_ROWS * K8_GB + lane * K8_GB + warp] : 0.0;
        v[u] = __dmul_rn(x, x);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = __dadd_rn(v[u], __shfl_down_sync(0xffffffffu, v[u], o));
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (p0 + u < p1) tot = __dadd_rn(tot, v[u]);
    }
  };
  squares(zsh, 0, np < K8_ZCAP ? np : K8_ZCAP);
  squares(bt, K8_ZCAP, np);
  const int64_t gg = (int64_t)blockIdx.x * K8_GB + warp;
  if (lane == 0 && gg < g) chi2[gg] = __dsub_rn(s_in[gg], tot);
}

// raise a kernel's dynamic shared-memory limit to its largest use,
// once per device
static int smem_limit(const void* kernel, size_t bytes, bool (&done)[64]) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 64 && done[dev]) return 0;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (!err && dev < 64) done[dev] = true;
  return err;
}

// launch a kernel that may start while the one before it on the
// stream finishes (programmatic dependent launch): it calls
// griddepcontrol.wait before it reads what that one wrote
template <typename... P, typename... A>
static cudaError_t launch_after(void (*kernel)(P...), int64_t blocks,
                                size_t smem, cudaStream_t st, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(K8_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// rows per split of stage 1: whole 32-row chunks, as few as keep its
// blocks (the diagonal inversions included) within K8_BLOCKS while a
// split keeps a chunk
static int64_t split_rows(int64_t g, int64_t n, int64_t k_pre, int64_t k_e,
                          int64_t k_post) {
  const K8Shape sh(g, n, k_pre, k_e, k_post, K8_ROWS);
  int64_t want = (K8_BLOCKS - sh.np) / (sh.tiles_a * sh.nc);
  if (want < 1) want = 1;
  return ((n + want - 1) / want + K8_ROWS - 1) / K8_ROWS * K8_ROWS;
}

// the plan of a shape, for the caller: out[0] rows per split, out[1]
// splits, out[2] stage 1's blocks, out[3] the scratch the launcher takes,
// in doubles
extern "C" int woodbury_chi2_pre_plan(int64_t g, int64_t n, int64_t k_pre,
                                      int64_t k_e, int64_t k_post,
                                      int64_t* out) {
  if (g <= 0 || n <= 0 || k_pre < 0 || k_e < 0 || k_post < 0)
    return (int)cudaErrorInvalidValue;
  const K8Shape sh(g, n, k_pre, k_e, k_post,
                   split_rows(g, n, k_pre, k_e, k_post));
  out[0] = sh.rs;
  out[1] = sh.ns;
  out[2] = sh.np + sh.ns * sh.tiles_a * sh.nc;
  out[3] = sh.scratch_len();
  return 0;
}

// scratch: woodbury_chi2_pre_plan's out[3] doubles, allocated by the
// caller
extern "C" int woodbury_chi2_pre_launch(
    const void* r, const void* nvec, const void* pre, const void* perm,
    const void* offsets, const void* post, const void* lt, void* chi2,
    void* scratch, int64_t scratch_len, int64_t g, int64_t n,
    int64_t k_pre, int64_t k_e, int64_t k_post, void* stream) {
  if (g <= 0 || n <= 0 || k_pre < 0 || k_e < 0 || k_post < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t rs = split_rows(g, n, k_pre, k_e, k_post);
  const K8Shape sh(g, n, k_pre, k_e, k_post, rs);
  const int64_t blocks1 = sh.np + sh.ns * sh.tiles_a * sh.nc;
  const int64_t blocks2 = ((1 + sh.kd) * sh.gp + K8_RT - 1) / K8_RT;
  if (scratch_len < sh.scratch_len() || blocks1 > 0x7fffffff ||
      blocks2 > 0x7fffffff || sh.tiles_b > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  double* dpart = (double*)scratch;
  double* bz = dpart + sh.dpart_len();
  double* dinv = bz + sh.bz_len();
  double* s = dinv + sh.dinv_len();
  const cudaStream_t st = (cudaStream_t)stream;
  woodbury_rhs_kernel<<<(unsigned)blocks1, K8_THREADS, 0, st>>>(
      (const double*)r, (const double*)nvec, (const double*)pre,
      (const int32_t*)perm, (const int32_t*)offsets, (const double*)post,
      (const double*)lt, dpart, bz, dinv, g, n, k_pre, k_e, k_post, rs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  static bool reduce_done[64] = {false}, solve_done[64] = {false};
  int lerr = smem_limit((const void*)woodbury_reduce_kernel,
                        reduce_smem(K8_RS), reduce_done);
  if (lerr) return lerr;
  err = launch_after(woodbury_reduce_kernel, blocks2, reduce_smem(sh.ns), st,
                     (const double*)dpart, bz, s, g, n, k_pre, k_e, k_post,
                     rs);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lerr = smem_limit((const void*)woodbury_solve_kernel, solve_smem(K8_ZCAP),
                    solve_done);
  if (lerr) return lerr;
  err = launch_after(woodbury_solve_kernel, sh.tiles_b, solve_smem(sh.np),
                     st, (const double*)lt, (const double*)dinv, bz,
                     (const double*)s, (double*)chi2, g, sh.k);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
