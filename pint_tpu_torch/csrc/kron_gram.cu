// Kernel K3: the ragged per-pulsar weighted gram of the kron-structured
// PTA likelihood and the optimal statistic's whitening.
//
// Replaces pint_tpu/linalg.py:605 kron_gram_precompute (the einsums
// "pni,pn,pnj->pij" over padded per-pulsar stacks), which
// gw/common.py:_kron_lnlike_one and gw/os.py:_zm_one reach.
//
// For each pulsar a, over its own rows only, with w = 1/sigma^2 and
// T_a = [U_a | F_a | r_a] (n_a rows, w_a = nb_a + m2 + 1 columns):
//
//   gram[a] = T_a^T diag(w) T_a        (g_uu, g_uf, g_ff, b_u, b_f, rr)
//   ld_white[a] = sum_n log(sigma_n^2)
//
// Layout: pulsar a's rows are row-major (n_a, w_a) at element t_off[a]
// of t, its sigmas at sigma[row_off[a] .. row_off[a+1]).  The output is
// padded to the widest pulsar: gram (P, Wp, Wp), Wp = nb_max + m2 + 1,
// pulsar column c placed at c (U) or c + nb_max - nb_a (F, r); pad
// entries are exact zeros (the launcher zero-fills when widths differ)
// and (i, j) and (j, i) are the same number.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp64 on the tensor
// cores): at P = 68, 500 rows, width 92 the function moves 30 MB
// (~9 us) and does ~0.3 GFLOP of the symmetric half (~4.4 us); at 10^4
// rows per pulsar T is 0.5 GB, ~0.15 ms of bytes against ~0.09 ms of
// operations.  Bytes bound it at both shapes.  Measured on the card:
// mma.sync m8n8k4 f64 peaks at ~33 TFLOP/s, half the data sheet, and
// m16n8k4/k8/k16 f64 (sm_90) at 61-66; at m8n8k4's rate the products
// alone would take ~0.2 ms at 10^4 rows, over the byte bound, so K3
// runs on m16n8k8.
//
// Design: T is read once, and the products run on the fp64 tensor
// cores (mma.sync m16n8k8 f64).
// - Pass 1, kron_gram_partial_kernel: one block per (pulsar, row split,
//   block group).  A pulsar's rows are cut into S_a = clamp(ceil(n_a /
//   split_rows), 1, max_splits) even splits (host constants, so the
//   bits do not depend on the card).  A block stages its rows in chunks
//   of 32 through a double-buffered 8-byte cp.async ring (ragged
//   offsets and odd widths rule out 16-byte copies and TMA), transposed
//   (column-major, stride 40), so each thread's two k-values of a
//   fragment are one 16-byte shared load.  The gram's upper triangle is
//   cut into 16 x 8 blocks (42 at width 92), up to 6 per warp held in
//   registers.  1/sigma^2 is applied to the A fragments, once per
//   fragment load; one warp forms the next chunk's weights and
//   log sigma^2 while the others multiply, so a chunk costs one
//   barrier.  The block writes its 16 x 8 blocks and its log sum to a
//   scratch buffer the launcher allocates.
// - Pass 2, kron_gram_reduce_kernel: one thread per entry of those
//   records adds the pulsar's split partials in ascending split order
//   and writes (i, j) and (j, i); one thread per pulsar writes ld_white.
// Order: every sum has one owner and a fixed order (no atomics), so the
// result is bit-identical from run to run.  -fmad=false does not reach
// the MMA, which rounds its own 8-term sums; the tolerance against the
// plain version is n eps sum|terms|.  Shared memory per block: two
// stages of roundup16(Wp) x 40 doubles, 62 kB at Wp = 92; registers
// allow two blocks on an SM.

#include <cstdint>
#include <cuda_runtime.h>

#define THREADS 256
#define WARPS 8
#define RC 32           // rows per staged chunk
#define LDR (RC + 8)    // column stride of a stage, = 8 mod 16 doubles
#define MAXB 6          // 16 x 8 blocks per warp, at most
#define BPB (WARPS * MAXB)

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

__device__ __forceinline__ int n_splits(int n, int split_rows,
                                        int max_splits) {
  const int s = (n + split_rows - 1) / split_rows;
  return s < 1 ? 1 : (s > max_splits ? max_splits : s);
}

__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) & ~15;
}

// 16 x 8 blocks (I, J), J >= 2 I, of the upper triangle of a gram whose
// width rounds up to 16 nI: nI (nI + 1), row-major
__host__ __device__ __forceinline__ int n_blocks16(int w) {
  const int ni = round16(w) >> 4;
  return ni * (ni + 1);
}

static size_t partial_smem(int wp) {
  return sizeof(double) * (2 * round16(wp) * LDR + 2 * RC + 3 * RC);
}

__global__ void __launch_bounds__(THREADS, 2)
    kron_gram_partial_kernel(const double* __restrict__ t,
                             const double* __restrict__ sigma,
                             const int64_t* __restrict__ row_off,
                             const int64_t* __restrict__ t_off,
                             const int32_t* __restrict__ nb,
                             double* __restrict__ part,
                             double* __restrict__ ld_part, int nb_max,
                             int m2, int ndm, int split_rows,
                             int max_splits) {
  extern __shared__ double smem[];
  const int a = blockIdx.x, s = blockIdx.y, grp = blockIdx.z;
  const int64_t r0a = row_off[a];
  const int n = (int)(row_off[a + 1] - r0a);
  const int ns = n_splits(n, split_rows, max_splits);
  if (s >= ns) return;
  const int w = nb[a] + m2 + 1;
  const int nj = round16(w) >> 3;
  const int nd = n_blocks16(w);
  const int b_first = grp * BPB;
  if (b_first >= nd) return;
  const int rb = (int)((int64_t)s * n / ns);
  const int re = (int)((int64_t)(s + 1) * n / ns);

  const int sd = round16(nb_max + m2 + 1) * LDR;  // doubles per stage
  double* st = smem;               // [2][column][LDR]: T chunk, transposed
  double* wsh = smem + 2 * sd;     // [2][RC]: 1 / sigma^2, 0 past the end
  double* sg = wsh + 2 * RC;       // [3][RC]: sigma, one chunk ahead
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;

  // this warp's blocks: a contiguous run of the row-major list, the
  // group's blocks spread evenly over the warps
  const int nd_g = min(BPB, nd - b_first);
  const int cnt = (nd_g >> 3) + (warp < (nd_g & 7) ? 1 : 0);
  const int b0 = b_first + warp * (nd_g >> 3) + min(warp, nd_g & 7);
  int bi = cnt > 0 ? b0 : 0, bI = 0;
  while (bi >= nj - 2 * bI) {
    bi -= nj - 2 * bI;
    ++bI;
  }
  int bJ = 2 * bI + bi;
  int off_a[MAXB], off_b[MAXB];
#pragma unroll
  for (int q = 0; q < MAXB; ++q) {
    const bool real = q < cnt;  // a spare slot reads block (0, 0)
    off_a[q] = ((real ? bI * 16 : 0) + g) * LDR + 2 * tg;
    off_b[q] = ((real ? bJ * 8 : 0) + g) * LDR + 2 * tg;
    if (++bJ == nj) {
      ++bI;
      bJ = 2 * bI;
    }
  }
  double acc[MAXB][4];
#pragma unroll
  for (int q = 0; q < MAXB; ++q)
    acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0;

  for (int e = tid; e < 2 * sd + 2 * RC; e += THREADS) smem[e] = 0.0;
  __syncthreads();

  const double* ta = t + t_off[a];
  const double* sa = sigma + r0a;
  const int n_chunks = (re - rb + RC - 1) / RC;
  const int cgs = (w + 3) >> 2;  // 4-column groups of a row
  // copy chunk c of T (8 rows x 4 columns a warp instruction) into its
  // stage, transposed; zero the rows past the split's end
  auto stage_t = [&](int c) {
    const int row0 = rb + c * RC;
    const int rows = min(RC, re - row0);
    double* dst = st + (c & 1) * sd;
    for (int task = warp; task < (RC / 8) * cgs; task += WARPS) {
      const int row = 8 * (task % (RC / 8)) + g;
      const int col = 4 * (task / (RC / 8)) + tg;
      if (row < rows && col < w)
        cp_async8(dst + col * LDR + row,
                  ta + (int64_t)(row0 + row) * w + col);
    }
    if (rows < RC)
      for (int e = tid; e < w * RC; e += THREADS) {
        const int col = e / RC, row = e % RC;
        if (row >= rows) dst[col * LDR + row] = 0.0;
      }
  };
  auto stage_sig = [&](int c) {
    const int row0 = rb + c * RC;
    if (c < n_chunks && tid < min(RC, re - row0))
      cp_async8(sg + (c % 3) * RC + tid, sa + row0 + tid);
  };
  // warp WARPS-1 forms chunk c's weights (a row per lane and step) and
  // adds its log sigma^2 to the lane's running sum
  double ld_acc = 0.0;
  auto weights = [&](int c) {
    const int row0 = rb + c * RC;
    for (int r = lane; r < RC; r += 32) {
      double v = 0.0;
      if (c < n_chunks && r < re - row0) {
        const double sv = sg[(c % 3) * RC + r];
        const double s2 = __dmul_rn(sv, sv);
        v = __ddiv_rn(1.0, s2);
        if (grp == 0) ld_acc = __dadd_rn(ld_acc, log(s2));
      }
      wsh[(c & 1) * RC + r] = v;
    }
  };

  if (n_chunks > 0) {
    stage_t(0);
    stage_sig(0);
    stage_sig(1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (warp == WARPS - 1) weights(0);
  }
  for (int c = 0; c < n_chunks; ++c) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // chunk c and sigma of c + 1 landed, weights of c
                      // formed, every warp past chunk c - 1
    if (c + 1 < n_chunks) stage_t(c + 1);
    stage_sig(c + 2);
    asm volatile("cp.async.commit_group;\n" ::);
    if (warp == WARPS - 1) weights(c + 1);
    const double* sb = st + (c & 1) * sd;
    const double* wb = wsh + (c & 1) * RC;
#pragma unroll
    for (int k = 0; k < RC; k += 8) {
      // k-index tg of the MMA is row k + 2 tg, k-index tg + 4 row
      // k + 2 tg + 1: one 16-byte load per column
      const double2 wv =
          *reinterpret_cast<const double2*>(wb + k + 2 * tg);
      double2 bv[MAXB];
#pragma unroll
      for (int q = 0; q < MAXB; ++q)
        bv[q] = *reinterpret_cast<const double2*>(sb + off_b[q] + k);
      double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
#pragma unroll
      for (int q = 0; q < MAXB; ++q) {
        if (q == 0 || off_a[q] != off_a[q - 1]) {
          const double2 x =
              *reinterpret_cast<const double2*>(sb + off_a[q] + k);
          const double2 y = *reinterpret_cast<const double2*>(
              sb + off_a[q] + 8 * LDR + k);
          a0 = __dmul_rn(x.x, wv.x);
          a2 = __dmul_rn(x.y, wv.y);
          a1 = __dmul_rn(y.x, wv.x);
          a3 = __dmul_rn(y.y, wv.y);
        }
        if (q < cnt) mma16(acc[q], a0, a1, a2, a3, bv[q].x, bv[q].y);
      }
    }
  }

  // each 16 x 8 block is two 8 x 8 row-major records, rows 2I and 2I + 1
  double* pb = part + ((int64_t)a * max_splits + s) * ndm * 128;
#pragma unroll
  for (int q = 0; q < MAXB; ++q) {
    if (q < cnt) {
      double2* rec =
          reinterpret_cast<double2*>(pb + (int64_t)(b0 + q) * 128);
      rec[lane] = make_double2(acc[q][0], acc[q][1]);
      rec[32 + lane] = make_double2(acc[q][2], acc[q][3]);
    }
  }
  if (grp == 0 && warp == WARPS - 1) {
    // the lanes' log sums, a fixed shuffle tree
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      ld_acc = __dadd_rn(ld_acc, __shfl_down_sync(0xffffffffu, ld_acc, o));
    if (lane == 0) ld_part[a * max_splits + s] = ld_acc;
  }
}

__global__ void __launch_bounds__(THREADS)
    kron_gram_reduce_kernel(const int64_t* __restrict__ row_off,
                            const int32_t* __restrict__ nb,
                            const double* __restrict__ part,
                            const double* __restrict__ ld_part,
                            double* __restrict__ gram,
                            double* __restrict__ ld_white, int nb_max,
                            int m2, int ndm, int split_rows,
                            int max_splits) {
  const int a = blockIdx.y;
  const int wp = nb_max + m2 + 1;
  const int n = (int)(row_off[a + 1] - row_off[a]);
  const int ns = n_splits(n, split_rows, max_splits);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    double v = ld_part[a * max_splits];
    for (int s = 1; s < ns; ++s)
      v = __dadd_rn(v, ld_part[a * max_splits + s]);
    ld_white[a] = v;
  }
  const int nba = nb[a], w = nba + m2 + 1;
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= n_blocks16(w) * 128) return;
  // record entry -> block (I, J), half, entry (r, c)
  const int nj = round16(w) >> 3;
  int bi = e >> 7, bI = 0;
  while (bi >= nj - 2 * bI) {
    bi -= nj - 2 * bI;
    ++bI;
  }
  const int i = (2 * bI + ((e >> 6) & 1)) * 8 + ((e >> 3) & 7);
  const int j = (2 * bI + bi) * 8 + (e & 7);
  if (i > j || j >= w) return;  // lower half, or past the pulsar's width
  const double* p = part + (int64_t)a * max_splits * ndm * 128 + e;
  const int64_t stride = (int64_t)ndm * 128;
  double v = p[0];
#pragma unroll 4
  for (int s = 1; s < ns; ++s) v = __dadd_rn(v, p[s * stride]);
  const int shift = nb_max - nba;
  const int pi = i < nba ? i : i + shift;
  const int pj = j < nba ? j : j + shift;
  double* ga = gram + (int64_t)a * wp * wp;
  ga[pi * wp + pj] = v;
  ga[pj * wp + pi] = v;
}

// raise pass 1's dynamic shared-memory limit once per device and size
static int partial_smem_limit(int wp) {
  static int done[64] = {0};
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  const int bytes = (int)partial_smem(wp);
  if (dev < 64 && bytes <= done[dev]) return 0;
  err = (int)cudaFuncSetAttribute((const void*)kron_gram_partial_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  bytes);
  if (!err && dev < 64) done[dev] = bytes;
  return err;
}

// part: (P, max_splits, n_blocks16(Wp), 128) doubles, ld_part:
// (P, max_splits) -- scratch, allocated by the caller
extern "C" int kron_gram_launch(const void* t, const void* sigma,
                                const void* row_off, const void* t_off,
                                const void* nb, void* part, void* ld_part,
                                void* gram, void* ld_white, int64_t n_psr,
                                int64_t nb_max, int64_t m2,
                                int64_t split_rows, int64_t max_splits,
                                void* stream) {
  const int wp = (int)(nb_max + m2 + 1);
  const int ndm = n_blocks16(wp);
  int err = partial_smem_limit(wp);
  if (err) return err;
  const dim3 grid1((unsigned)n_psr, (unsigned)max_splits,
                   (unsigned)((ndm + BPB - 1) / BPB));
  kron_gram_partial_kernel<<<grid1, THREADS, partial_smem(wp),
                             (cudaStream_t)stream>>>(
      (const double*)t, (const double*)sigma, (const int64_t*)row_off,
      (const int64_t*)t_off, (const int32_t*)nb, (double*)part,
      (double*)ld_part, (int)nb_max, (int)m2, ndm, (int)split_rows,
      (int)max_splits);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid2((unsigned)((ndm * 128 + THREADS - 1) / THREADS),
                   (unsigned)n_psr);
  kron_gram_reduce_kernel<<<grid2, THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)row_off, (const int32_t*)nb, (const double*)part,
      (const double*)ld_part, (double*)gram, (double*)ld_white,
      (int)nb_max, (int)m2, ndm, (int)split_rows, (int)max_splits);
  return (int)cudaGetLastError();
}

// blocks of pass 1 that fit on one SM at this width
extern "C" int kron_gram_occupancy(int64_t nb_max, int64_t m2) {
  const int wp = (int)(nb_max + m2 + 1);
  int err = partial_smem_limit(wp);
  if (err) return -err;
  int n = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kron_gram_partial_kernel, THREADS, partial_smem(wp));
  return err ? -err : n;
}
