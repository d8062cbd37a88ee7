// Kernel K7: the whitening pass of the WLS Gauss-Newton step, for one
// design or a batch of G designs (the points of a chi^2 grid).
//
// Replaces pint_tpu/fitter.py:152-158 inside wls_gn_solve:
//
//   w = 1 / err;  rw = r * w;  Jw = J * w[:, None]
//   norms = sqrt(sum_i Jw[i, :]^2), zeros replaced by 1
//   Jn = Jw / norms;  chi2 = sum_i rw[i]^2
//
// Per point g: r (N,), J (N, P) row-major and err (N,) in (err shared
// by every point, err_stride 0, or one row per point, err_stride N);
// rw (N,), Jn (N, P), norms (P,) and chi2 out, all float64, the points
// stacked in front.  The SVD that follows stays a library call.
//
// Why by hand: the column sums over N must come out the same on every
// run; torch.sum on CUDA does not promise a reduction order.  Here the
// order is fixed by construction, as in K2 and K3.
//
// Bound on an H100 (3.35 TB/s): memory.  J, r and err are read once and
// Jn, rw written once: 8 G (2 N P + 2 N) + 8 N bytes, ~1.9 MB at one
// point of N = 10^4, P = 11 (~0.6 us, so launch latency is the real
// cost), ~290 MB at a 256-point grid of P = 8 (~87 us).
//
// The order.  A point's rows are cut into tiles of 32 (the last one
// shorter); a warp sums a tile.  With C = min(P + 1, 32) columns a round
// (column P is rw's), lane l takes column l % C and the tile's rows
// l / C, l / C + R, ... (R = 32 / C) in ascending order, squares of
// J w (r w) added one by one; the R sums of a column are then added in
// ascending order (shuffles), and the tile's partial is stored at (g,
// column, tile).  The norms: a warp a column sums the point's tile
// partials, lane l those of tiles l, l + 32, ... in ascending order,
// then a fixed xor butterfly (every lane holds the same bits); sqrt, a
// zero replaced by 1.  The order depends on N and P alone, so both forms
// below give the same bits, and a point of a batch the bits of the same
// point alone.
//
// Two forms:
// - one cooperative launch (wls_whiten_coop) where every block of every
//   point is co-resident with its rows in shared memory: a block of 8
//   warps stages its 256 rows of J (contiguous, 256 P doubles; a tile a
//   warp) by cp.async, 16 bytes a
//   copy where J is 16-byte aligned (8 at the odd ends), with their r
//   and w = 1 / err; its warps sum their tiles from there; one grid
//   sync; the norms; Jn = (J w) / norm and rw = r w written from the
//   staged rows, consecutive threads on consecutive addresses.  J is
//   read once (the WLS fit's 10^4 x 11: 40 blocks).
// - else two launches (the WLS grid's 256 x 10^4 x 8, 164 MB of J), 8
//   warps a block: wls_whiten_tile_sums, whose warps read their tiles
//   straight from
//   global memory (a warp's loads cover whole rows, coalesced), then
//   wls_whiten_apply, each block its point's norms and then a run of
//   rows, its w in shared memory, Jn and rw with four loads in flight a
//   thread.  J is read twice.
// rw and Jn use the plain version's operations in its order (one
// correctly rounded multiply, one division), so for equal norms they are
// bit-identical to it; the norms and chi2 differ from torch.sum's only
// by summation order.  -fmad=false keeps every product separately
// rounded.  Offsets are int64 products.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define K7_THREADS 256
#define K7_WARPS (K7_THREADS / 32)
#define K7_TILE 32                          // rows a warp sums
#define K7_BLOCK_ROWS (K7_WARPS * K7_TILE)  // rows a block takes
// the most shared memory a cooperative block stages
#define K7_COOP_SMEM (200 * 1024)
// the apply's blocks over all points, and its most rows a block
#define K7_APPLY_BLOCKS 1056
#define K7_APPLY_ROWS 8192
#define FULL 0xffffffffu

struct K7Args {
  const double* r;
  const double* J;
  const double* err;
  double* partial;  // (G, P + 1, tiles)
  double* rw;
  double* jn;
  double* norms;
  double* chi2;
  int64_t n, p, err_stride, tiles;
  int vec;  // J 16-byte aligned
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// a cooperative block's shared memory (doubles): its rows of J (+ 2 for
// the alignment shift), r, w, the column values
__host__ __device__ inline int64_t coop_doubles(int64_t p) {
  return K7_BLOCK_ROWS * p + 2 + 2 * K7_BLOCK_ROWS + (p + 1);
}

// the sums of one tile (rows row0 .. row0 + nrows - 1 of point g) into
// partial (g, c, t): J's entry (i, c) of the tile is jat(i, c), r's
// rat(i), w's wat(i); the whole warp calls it
template <class JAt, class RAt, class WAt>
__device__ __forceinline__ void tile_sums(const K7Args& a, int64_t g,
                                          int64_t t, int nrows, JAt jat,
                                          RAt rat, WAt wat) {
  const int lane = threadIdx.x & 31;
  const int64_t p = a.p;
  const int C = p + 1 < 32 ? (int)(p + 1) : 32;
  const int R = 32 / C, lr = lane / C, cj = lane - lr * C;
  for (int64_t c0 = 0; c0 <= p; c0 += C) {
    const int64_t c = c0 + cj;
    double acc = 0.0;
    if (lr < R && c <= p) {
#pragma unroll 4
      for (int i = lr; i < nrows; i += R) {
        const double v = __dmul_rn(c < p ? jat(i, c) : rat(i), wat(i));
        acc = __dadd_rn(acc, __dmul_rn(v, v));
      }
    }
    double s = acc;
    for (int l = 1; l < R; ++l)
      s = __dadd_rn(s, __shfl_sync(FULL, acc, cj + l * C));
    if (lane < C && c <= p) a.partial[(g * (p + 1) + c) * a.tiles + t] = s;
  }
}

// the norms of point g (and chi2 in col[p]) from its tile partials,
// in the same order in every block; `write` stores norms and chi2
__device__ void column_norms(const K7Args& a, int64_t g, double* col,
                             bool write) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t c = warp; c <= a.p; c += K7_WARPS) {
    const double* pc = a.partial + (g * (a.p + 1) + c) * a.tiles;
    double v = 0.0;
    for (int64_t t0 = lane; t0 < a.tiles; t0 += 16 * 32) {
      double x[16];  // loaded together, added in order
#pragma unroll
      for (int q = 0; q < 16; ++q)
        x[q] = t0 + q * 32 < a.tiles ? pc[t0 + q * 32] : 0.0;
#pragma unroll
      for (int q = 0; q < 16; ++q)
        if (t0 + q * 32 < a.tiles) v = __dadd_rn(v, x[q]);
    }
    for (int off = 16; off > 0; off >>= 1)
      v = __dadd_rn(v, __shfl_xor_sync(FULL, v, off));
    if (lane == 0) {
      if (c < a.p) {
        const double nrm = sqrt(v);
        col[c] = nrm == 0.0 ? 1.0 : nrm;
        if (write) a.norms[g * a.p + c] = col[c];
      } else {
        col[c] = v;
        if (write) a.chi2[g] = v;
      }
    }
  }
  __syncthreads();
}

// one cooperative launch, grid (blocks of 8 tiles, G): each block keeps
// its rows in shared memory across the grid sync
__global__ void __launch_bounds__(K7_THREADS) wls_whiten_coop(K7Args a) {
  extern __shared__ __align__(16) double sm[];
  const int64_t g = blockIdx.y, p = a.p;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int64_t row0 = (int64_t)blockIdx.x * K7_BLOCK_ROWS;
  const int nrows =
      (int)(a.n - row0 < K7_BLOCK_ROWS ? a.n - row0 : K7_BLOCK_ROWS);
  double* Jt = sm;
  double* rt = sm + K7_BLOCK_ROWS * p + 2;
  double* wt = rt + K7_BLOCK_ROWS;
  double* col = wt + K7_BLOCK_ROWS;
  // stage: Jt[shift + e] holds the block's element e of J
  const int64_t e0 = (g * a.n + row0) * p, e1 = e0 + nrows * p;
  int64_t shift = 0;
  if (a.vec) {
    shift = e0 & 1;
    const int64_t hi = e1 & ~(int64_t)1;
    for (int64_t e = e0 + shift + 2 * tid; e < hi; e += 2 * K7_THREADS)
      cp_async16(Jt + shift + (e - e0), a.J + e);
    if (tid == 0 && e1 > e0) {
      if (e0 & 1) cp_async8(Jt + shift, a.J + e0);
      if (e1 & 1) cp_async8(Jt + shift + (e1 - 1 - e0), a.J + e1 - 1);
    }
  } else {
    for (int64_t e = e0 + tid; e < e1; e += K7_THREADS)
      cp_async8(Jt + (e - e0), a.J + e);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  const double* eg = a.err + g * a.err_stride + row0;
  const double* rg = a.r + g * a.n + row0;
  for (int i = tid; i < nrows; i += K7_THREADS) {
    wt[i] = 1.0 / eg[i];
    rt[i] = rg[i];
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  const int t0 = warp * K7_TILE;
  const int64_t t = (int64_t)blockIdx.x * K7_WARPS + warp;
  if (t < a.tiles) {
    const double* Jw = Jt + shift + (int64_t)t0 * p;
    tile_sums(
        a, g, t, nrows - t0 < K7_TILE ? nrows - t0 : K7_TILE,
        [&](int i, int64_t c) { return Jw[i * p + c]; },
        [&](int i) { return rt[t0 + i]; },
        [&](int i) { return wt[t0 + i]; });
  }
  cg::this_grid().sync();
  column_norms(a, g, col, blockIdx.x == 0);
  // rw and Jn from the staged rows
  const int64_t base = g * a.n + row0;
  for (int i = tid; i < nrows; i += K7_THREADS) a.rw[base + i] = rt[i] * wt[i];
  if (p == 0) return;
  const int64_t ne = nrows * p, di = K7_THREADS / p, dc = K7_THREADS - di * p;
  int64_t i = tid / p, c = tid - (tid / p) * p;
  double* jn = a.jn + base * p;
  for (int64_t e = tid; e < ne; e += K7_THREADS) {
    const double jw = Jt[shift + e] * wt[i];
    jn[e] = jw / col[c];
    i += di;
    c += dc;
    if (c >= p) {
      c -= p;
      i += 1;
    }
  }
}

// two launches, 1: the tiles' partials from global memory, grid (blocks
// of 8 tiles, G)
__global__ void __launch_bounds__(K7_THREADS)
wls_whiten_tile_sums(K7Args a) {
  const int64_t g = blockIdx.y, p = a.p;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t = (int64_t)blockIdx.x * K7_WARPS + warp;
  if (t >= a.tiles) return;
  const int64_t row0 = t * K7_TILE;
  const int nrows = (int)(a.n - row0 < K7_TILE ? a.n - row0 : K7_TILE);
  // the tile's w and r, a lane a row
  __shared__ double wsh[K7_WARPS][K7_TILE], rsh[K7_WARPS][K7_TILE];
  if (lane < nrows) {
    wsh[warp][lane] = 1.0 / a.err[g * a.err_stride + row0 + lane];
    rsh[warp][lane] = a.r[g * a.n + row0 + lane];
  }
  __syncwarp();
  const double* Jg = a.J + (g * a.n + row0) * p;
  const double* wr = wsh[warp];
  const double* rr = rsh[warp];
  tile_sums(
      a, g, t, nrows, [&](int i, int64_t c) { return Jg[i * p + c]; },
      [&](int i) { return rr[i]; }, [&](int i) { return wr[i]; });
}

// two launches, 2: grid (blocks, G), each block its point's norms, then
// its run of rows from global memory
__global__ void __launch_bounds__(K7_THREADS) wls_whiten_apply(K7Args a,
                                                                int64_t rb) {
  extern __shared__ __align__(16) double sm[];  // w (rb), col (p + 1)
  const int64_t g = blockIdx.y, p = a.p;
  const int tid = threadIdx.x;
  double* wt = sm;
  double* col = sm + rb;
  const int64_t row0 = (int64_t)blockIdx.x * rb;
  if (row0 >= a.n) return;
  const int64_t nrows = a.n - row0 < rb ? a.n - row0 : rb;
  const double* eg = a.err + g * a.err_stride + row0;
  for (int64_t i = tid; i < nrows; i += K7_THREADS) wt[i] = 1.0 / eg[i];
  column_norms(a, g, col, blockIdx.x == 0);  // ends with a barrier
  const int64_t base = g * a.n + row0;
  for (int64_t i = tid; i < nrows; i += K7_THREADS)
    a.rw[base + i] = a.r[base + i] * wt[i];
  if (p == 0) return;
  const double* Jg = a.J + base * p;
  double* jn = a.jn + base * p;
  const int64_t ne = nrows * p, step = 4 * K7_THREADS;
  const int64_t di = K7_THREADS / p, dc = K7_THREADS - di * p;
  int64_t i = tid / p, c = tid - (tid / p) * p;
  for (int64_t e0 = tid; e0 < ne; e0 += step) {
    double v[4];
    int64_t ii[4], cc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int64_t e = e0 + u * K7_THREADS;
      v[u] = e < ne ? Jg[e] : 0.0;
      ii[u] = i;
      cc[u] = c;
      i += di;
      c += dc;
      if (c >= p) {
        c -= p;
        i += 1;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int64_t e = e0 + u * K7_THREADS;
      if (e < ne) jn[e] = (v[u] * wt[ii[u]]) / col[cc[u]];
    }
  }
}

static int64_t tiles_of(int64_t n) { return (n + K7_TILE - 1) / K7_TILE; }

extern "C" int wls_whiten_tiles(int64_t n, int64_t p) {
  return n > 0 && p >= 0 ? (int)tiles_of(n) : 0;
}

// whether one cooperative launch takes (g, n, p): every block of every
// point co-resident with its rows in shared memory (1), or not (0);
// negative: a CUDA error
extern "C" int wls_whiten_cooperative(int64_t g, int64_t n, int64_t p) {
  const size_t smem = sizeof(double) * coop_doubles(p);
  if (smem > K7_COOP_SMEM) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      wls_whiten_coop, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                  dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, wls_whiten_coop, K7_THREADS, smem)) != cudaSuccess)
    return -(int)e;
  const int64_t blocks = g * ((n + K7_BLOCK_ROWS - 1) / K7_BLOCK_ROWS);
  return coop && blocks <= (int64_t)per_sm * sms ? 1 : 0;
}

extern "C" int wls_whiten_launch(const void* r, const void* J,
                                 const void* err, void* partial, void* rw,
                                 void* jn, void* norms, void* chi2,
                                 int64_t g, int64_t n, int64_t p,
                                 int64_t err_stride, void* stream) {
  if (g <= 0 || g > 65535 || n <= 0 || p < 0)
    return (int)cudaErrorInvalidValue;
  K7Args a{(const double*)r, (const double*)J, (const double*)err,
           (double*)partial, (double*)rw,       (double*)jn,
           (double*)norms,   (double*)chi2,     n,
           p,                err_stride,        tiles_of(n),
           (int)((uintptr_t)J % 16 == 0)};
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((n + K7_BLOCK_ROWS - 1) / K7_BLOCK_ROWS),
                  (unsigned)g);
  const int coop = wls_whiten_cooperative(g, n, p);
  if (coop < 0) return -coop;
  if (coop) {
    void* params[] = {&a};
    return (int)cudaLaunchCooperativeKernel(
        (const void*)wls_whiten_coop, grid, dim3(K7_THREADS), params,
        sizeof(double) * coop_doubles(p), st);
  }
  wls_whiten_tile_sums<<<grid, K7_THREADS, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the apply: at most K7_APPLY_BLOCKS blocks over all points where
  // they take at most K7_APPLY_ROWS rows a block
  int64_t bx = K7_APPLY_BLOCKS / g;
  if (bx < (n + K7_APPLY_ROWS - 1) / K7_APPLY_ROWS)
    bx = (n + K7_APPLY_ROWS - 1) / K7_APPLY_ROWS;
  if (bx > (n + K7_THREADS - 1) / K7_THREADS)
    bx = (n + K7_THREADS - 1) / K7_THREADS;
  const int64_t rb = (n + bx - 1) / bx;
  bx = (n + rb - 1) / rb;
  const size_t smem2 = sizeof(double) * (rb + p + 1);
  e = cudaFuncSetAttribute(wls_whiten_apply,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem2);
  if (e != cudaSuccess) return (int)e;
  wls_whiten_apply<<<dim3((unsigned)bx, (unsigned)g), K7_THREADS, smem2,
                     st>>>(a, rb);
  return (int)cudaGetLastError();
}
