// Kernel K10: the weighted moments of the streaming refit.
//
// Replaces the moment sums of pint_tpu/linalg.py:772-1000 (NormalBlocks,
// normal_blocks, normal_blocks_delta) and pint_tpu/fitter.py:1196-1274
// (the stream capture and the ten "+=" of _stream_refit_jit):
//
//   S[:, j] += sum_r A[r, :] w[r] A[r, c0 + j]     (j = 0 .. c - c0 - 1)
//
// in place, for a row-major A (n x c), weights w (n,) and an output
// block S (c x (c - c0)) with row stride lds, all float64.
//
// Every raw moment of the stream state is a block
// of one symmetric matrix A^T W A with A = [U | Jq | q | 1]; the caller
// keeps that matrix packed and calls this kernel twice:
//   - the capture (the one O(N) pass): A = [U_dense | Jq | q | 1] over
//     the whole bucket (10842 x 72 on the B1855-like case) and c0 = the
//     dense basis width, so only the columns of Jq, q and 1 are summed;
//   - the fold of an appended night: A = the 32-row block
//     [u_d | j_d | q_d | 1] (c = K + P + 2) and c0 = 0, added onto the
//     packed moments in place.
//
// Order.  Rows go in splits of K10_ROWS = 96 consecutive rows; every
// output sums its split's rows in ascending order,
//
//   acc = acc + (A[r, i] * w[r]) * A[r, c0 + j],
//
// and then the splits' sums in ascending split order.  Pass 1 writes
// each split's sums to partial[split] (with one split, the fold, it adds
// them straight into S); pass 2 adds the partials.  One owner per
// output, no atomics: the result repeats bit for bit from run to run,
// and -fmad=false keeps each product and sum separately rounded, which
// is what the plain version (pint_tpu_torch.linalg.stream_moments_plain)
// does in the same order.
//   - Pass 1 when every output group fits one block (one_tile: the
//     captures): stream_moments_partial_rows, one block per split,
//     stages the split's rows a chunk of 32 at a time (contiguous:
//     coalesced; the next chunk's loads in flight during this chunk's
//     sums), and each thread sums 4 outputs (i, j .. j + 3) from one
//     shared load of A w and two of A a row.  Its end lets pass 2 launch.
//   - Pass 1 otherwise (the fold): stream_moments_partial, one block per
//     (split, 32 x 16 tile of outputs), each thread 2 outputs of one
//     column (a warp's j are contiguous in S).
//   - Pass 2, stream_moments_reduce: one block per K10_RT consecutive
//     outputs.  For a fixed split a tile's partials are one contiguous
//     run, so the block copies up to K10_RS splits' partials at once
//     into shared memory (cp.async, each warp a split, each lane an
//     output, in two groups: the second half lands while the first is
//     summed), and warp 0, a lane per output, adds them in split order.
//     It is a programmatic dependent launch (its launch overlaps the end
//     of pass 1; griddepcontrol.wait holds its reads until pass 1 is
//     done).
// Loads are issued at clamped, valid addresses, all before the first
// store to shared memory, so that they are in flight together.  The
// split length sets the reduce's chain of dependent adds (113 at the
// capture's 10842 rows) against pass 1's parallelism: 113 blocks leave
// no SM of the H100's 132 with two, where 32-row splits (339 partials)
// and 64-row ones (170 blocks) measured slower.
//
// Bound on an H100 (3.35 TB/s, fp64 34 TFLOP/s): A and w are read once
// and S read and written once: 8 (n c + n + 2 c (c - c0)) bytes against
// 2 n c (c - c0) operations.  The capture is bound by its bytes (~6.3 MB,
// ~1.9 us); the fold reads and writes the (K + P + 2)^2 packed matrix
// (~3.6 MB at c = 473, ~1.1 us) for 14 MFLOP (~0.4 us).

#include <cstdint>
#include <cuda_runtime.h>

#define K10_THREADS 256
#define K10_WARPS (K10_THREADS / 32)
#define K10_ROWS 96    // rows per split (pint_tpu_torch.linalg.K10_ROWS)
#define K10_CHUNK 32   // rows staged at a time
#define K10_TI 32      // the tiled pass's output tile
#define K10_TJ 16
#define K10_NC 80      // widest A the one-tile pass takes
#define K10_RT 32      // outputs per reduce block
#define K10_RS 512     // splits staged per pass of the reduce (128 kB)

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

// the one-tile pass takes A when every output group fits one thread
__host__ __device__ __forceinline__ bool one_tile(int64_t c, int64_t cw) {
  return c <= K10_NC && c * ((cw + 3) / 4) <= K10_THREADS;
}

__global__ void __launch_bounds__(K10_THREADS)
stream_moments_partial(const double* __restrict__ A,
                       const double* __restrict__ w, double* __restrict__ S,
                       double* __restrict__ partial, int64_t n, int64_t c,
                       int64_t c0, int64_t lds, int64_t tiles_j) {
  __shared__ double ai[K10_CHUNK][K10_TI];
  __shared__ double aj[K10_CHUNK][K10_TJ];
  const int t = threadIdx.x;
  const int64_t split = blockIdx.x;
  const int64_t nsplit = gridDim.x;
  const int64_t cw = c - c0;
  const int64_t i0 = (int64_t)(blockIdx.y / tiles_j) * K10_TI;
  const int64_t j0 = (int64_t)(blockIdx.y % tiles_j) * K10_TJ;
  const int64_t row_end = (split + 1) * K10_ROWS < n ? (split + 1) * K10_ROWS
                                                     : n;
  // outputs (ti, tj) and (ti + 16, tj): a warp's j are contiguous in S
  const int tj = t % K10_TJ;
  const int ti = t / K10_TJ;
  double acc0 = 0.0, acc1 = 0.0;
  for (int64_t row0 = split * K10_ROWS; row0 < row_end;
       row0 += K10_CHUNK) {
    // every load at a clamped, valid address and all of them before the
    // first store to shared memory, so they are in flight together; the
    // pad entries are zeroed after
    constexpr int UI = K10_CHUNK * K10_TI / K10_THREADS;
    constexpr int UJ = K10_CHUNK * K10_TJ / K10_THREADS;
    double av[UI], wv[UI], bv[UJ];
#pragma unroll
    for (int u = 0; u < UI; ++u) {
      const int idx = t + K10_THREADS * u;
      const int64_t row = row0 + idx / K10_TI, i = i0 + idx % K10_TI;
      const int64_t rc = row < row_end ? row : row0;
      av[u] = __ldg(A + rc * c + (i < c ? i : c - 1));
      wv[u] = __ldg(w + rc);
    }
#pragma unroll
    for (int u = 0; u < UJ; ++u) {
      const int idx = t + K10_THREADS * u;
      const int64_t row = row0 + idx / K10_TJ, j = j0 + idx % K10_TJ;
      const int64_t rc = row < row_end ? row : row0;
      bv[u] = __ldg(A + rc * c + c0 + (j < cw ? j : cw - 1));
    }
    __syncthreads();  // the previous chunk's sums are done
#pragma unroll
    for (int u = 0; u < UI; ++u) {
      const int idx = t + K10_THREADS * u;
      const int r = idx / K10_TI, col = idx % K10_TI;
      ai[r][col] = row0 + r < row_end && i0 + col < c
                       ? __dmul_rn(av[u], wv[u]) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < UJ; ++u) {
      const int idx = t + K10_THREADS * u;
      const int r = idx / K10_TJ, col = idx % K10_TJ;
      aj[r][col] = row0 + r < row_end && j0 + col < cw ? bv[u] : 0.0;
    }
    __syncthreads();
    const int rows = row_end - row0 < K10_CHUNK ? (int)(row_end - row0)
                                                : K10_CHUNK;
#pragma unroll 8
    for (int r = 0; r < rows; ++r) {
      const double y = aj[r][tj];
      acc0 = __dadd_rn(acc0, __dmul_rn(ai[r][ti], y));
      acc1 = __dadd_rn(acc1, __dmul_rn(ai[r][ti + 16], y));
    }
  }
  const int64_t j = j0 + tj;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t i = i0 + ti + 16 * h;
    const double acc = h ? acc1 : acc0;
    if (i < c && j < cw) {
      if (nsplit == 1)
        S[i * lds + j] = __dadd_rn(S[i * lds + j], acc);
      else
        partial[(split * c + i) * cw + j] = acc;
    }
  }
}

// Pass 1 when every output fits one block (one_tile: the captures): one
// block per split stages the split's rows whole, a chunk at a time, A w
// and A[:, c0:] (contiguous rows: coalesced), and each thread sums the
// 4 outputs (i, j .. j + 3) in the tiled pass's order: one shared load
// of A w and two of A a row for 4 products, so that shared memory keeps
// up with the fp64 units.
__global__ void __launch_bounds__(K10_THREADS)
stream_moments_partial_rows(const double* __restrict__ A,
                            const double* __restrict__ w,
                            double* __restrict__ S,
                            double* __restrict__ partial, int64_t n,
                            int64_t c, int64_t c0, int64_t lds) {
  __shared__ __align__(16) double aw[K10_CHUNK][K10_NC];
  __shared__ __align__(16) double aj[K10_CHUNK][K10_NC];
  const int t = threadIdx.x;
  const int64_t split = blockIdx.x;
  const int cw = (int)(c - c0);
  const int cw4 = (cw + 3) & ~3;  // aj's columns: cw, zero-padded to 4
  const int64_t row_end = (split + 1) * K10_ROWS < n ? (split + 1) * K10_ROWS
                                                     : n;
  const int nq = cw4 / 4;
  const bool live = t < (int)c * nq;
  const int i = live ? t / nq : 0, j0 = live ? 4 * (t % nq) : 0;
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  // warp w stages rows w, w + 8, w + 16, w + 24 of a chunk; lane l
  // columns l, l + 32, l + 64.  The next chunk's loads go out before
  // this chunk's sums, all at valid addresses.
  const int lane = t & 31, warp = t >> 5;
  constexpr int RV = K10_CHUNK / K10_WARPS, CV = (K10_NC + 31) / 32;
  double av[RV][CV], bv[RV][CV], wv[RV];
  auto load = [&](int64_t row0) {
    const int64_t rows = row_end - row0;
#pragma unroll
    for (int v = 0; v < RV; ++v) {
      const int64_t rc =
          row0 + (warp + K10_WARPS * v < rows ? warp + K10_WARPS * v : 0);
      wv[v] = __ldg(w + rc);
#pragma unroll
      for (int h = 0; h < CV; ++h) {
        const int col = lane + 32 * h;
        av[v][h] = __ldg(A + rc * c + (col < c ? col : 0));
        bv[v][h] = __ldg(A + rc * c + c0 + (col < cw ? col : 0));
      }
    }
  };
  int64_t row0 = split * K10_ROWS;
  load(row0);
  for (; row0 < row_end; row0 += K10_CHUNK) {
    const int rows = row_end - row0 < K10_CHUNK ? (int)(row_end - row0)
                                                : K10_CHUNK;
    __syncthreads();  // the previous chunk's sums are done
#pragma unroll
    for (int v = 0; v < RV; ++v) {
      const int r = warp + K10_WARPS * v;
#pragma unroll
      for (int h = 0; h < CV; ++h) {
        const int col = lane + 32 * h;
        if (col < c)
          aw[r][col] = r < rows ? __dmul_rn(av[v][h], wv[v]) : 0.0;
        if (col < cw4) aj[r][col] = r < rows && col < cw ? bv[v][h] : 0.0;
      }
    }
    __syncthreads();
    if (row0 + K10_CHUNK < row_end) load(row0 + K10_CHUNK);
    if (live) {
#pragma unroll 8
      for (int r = 0; r < rows; ++r) {
        const double x = aw[r][i];
        const double2 y01 = *reinterpret_cast<const double2*>(&aj[r][j0]);
        const double2 y23 =
            *reinterpret_cast<const double2*>(&aj[r][j0 + 2]);
        acc[0] = __dadd_rn(acc[0], __dmul_rn(x, y01.x));
        acc[1] = __dadd_rn(acc[1], __dmul_rn(x, y01.y));
        acc[2] = __dadd_rn(acc[2], __dmul_rn(x, y23.x));
        acc[3] = __dadd_rn(acc[3], __dmul_rn(x, y23.y));
      }
    }
  }
  if (!live) {
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = j0 + e;
    if (j < cw) {
      if (gridDim.x == 1)
        S[i * lds + j] = __dadd_rn(S[i * lds + j], acc[e]);
      else
        partial[(split * c + i) * cw + j] = acc[e];
    }
  }
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// the reduce's shared memory: the partials of one pass
static size_t reduce_smem(int64_t nsplit) {
  return sizeof(double) * K10_RT *
         (size_t)(nsplit < K10_RS ? nsplit : K10_RS);
}

__global__ void __launch_bounds__(K10_THREADS)
stream_moments_reduce(const double* __restrict__ partial,
                      double* __restrict__ S, int64_t c, int64_t c0,
                      int64_t lds, int64_t nsplit) {
  extern __shared__ double st[];  // [split][K10_RT]
  const int64_t cw = c - c0;
  const int64_t total = c * cw;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t e = (int64_t)blockIdx.x * K10_RT + lane;
  const bool live = e < total;
  const double* col = st + lane;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // pass 1 is done
  double acc = 0.0;
  for (int64_t s0 = 0; s0 < nsplit; s0 += K10_RS) {
    const int cnt = nsplit - s0 < K10_RS ? (int)(nsplit - s0) : K10_RS;
    const int half = cnt / 2;
    // the pass's partials in two groups, so the sum of the first half
    // runs while the second lands
    for (int g = 0; g < 2; ++g) {
      const int lo = g ? half : 0, hi = g ? cnt : half;
      if (live)
        for (int r = lo + warp; r < hi; r += K10_WARPS)
          cp_async8(&st[r * K10_RT + lane], partial + (s0 + r) * total + e);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    for (int g = 0; g < 2; ++g) {
      if (g == 0)
        asm volatile("cp.async.wait_group 1;\n" ::);
      else
        asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();
      if (warp == 0 && live) {
        int r = g ? half : 0;
        const int hi = g ? cnt : half;
        if (s0 == 0 && r == 0 && r < hi) {
          acc = col[0];
          r = 1;
        }
        // unrolled, so the shared loads run ahead of the chain of adds
#pragma unroll 8
        for (; r < hi; ++r) acc = __dadd_rn(acc, col[r * K10_RT]);
      }
    }
    __syncthreads();  // the pass is summed before the next restages
  }
  if (warp == 0 && live) {
    const int64_t i = e / cw;
    const int64_t j = e % cw;
    S[i * lds + j] = __dadd_rn(S[i * lds + j], acc);
  }
}

// raise the reduce's dynamic shared-memory limit once per device
static int reduce_smem_limit() {
  static bool done[64] = {false};
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 64 && done[dev]) return 0;
  err = (int)cudaFuncSetAttribute((const void*)stream_moments_reduce,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)reduce_smem(K10_RS));
  if (!err && dev < 64) done[dev] = true;
  return err;
}

extern "C" int stream_moments_launch(const double* A, const double* w,
                                     double* S, double* partial, int64_t n,
                                     int64_t c, int64_t c0, int64_t lds,
                                     cudaStream_t stream) {
  const int64_t cw = c - c0;
  const int64_t nsplit = (n + K10_ROWS - 1) / K10_ROWS;
  const int64_t tiles_i = (c + K10_TI - 1) / K10_TI;
  const int64_t tiles_j = (cw + K10_TJ - 1) / K10_TJ;
  if (n <= 0 || cw <= 0 || c0 < 0 || lds < cw || nsplit > 2147483647 ||
      tiles_i * tiles_j > 65535)
    return (int)cudaErrorInvalidValue;
  if (one_tile(c, cw)) {
    stream_moments_partial_rows<<<(unsigned)nsplit, K10_THREADS, 0,
                                  stream>>>(A, w, S, partial, n, c, c0,
                                            lds);
  } else {
    dim3 grid((unsigned)nsplit, (unsigned)(tiles_i * tiles_j));
    stream_moments_partial<<<grid, K10_THREADS, 0, stream>>>(
        A, w, S, partial, n, c, c0, lds, tiles_j);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  const int rerr = reduce_smem_limit();
  if (rerr) return rerr;
  // programmatic dependent launch: the reduce's launch overlaps the end
  // of pass 1, and it waits for it (griddepcontrol.wait) before its reads
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((c * cw + K10_RT - 1) / K10_RT));
  cfg.blockDim = dim3(K10_THREADS);
  cfg.dynamicSmemBytes = reduce_smem(nsplit);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, stream_moments_reduce,
                           (const double*)partial, S, c, c0, lds, nsplit);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
