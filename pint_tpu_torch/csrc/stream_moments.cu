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
// Order.  Rows go in splits of K10_ROWS consecutive rows.  Pass 1
// (stream_moments_partial) runs one block per (row split, 64 x 32 tile
// of outputs): it stages its split's rows of the tile's columns in
// shared memory, A[r, i] * w[r] for the tile's rows, and each thread
// owns 4 x 2 outputs, summing its split's rows in ascending order:
//
//   acc = acc + (A[r, i] * w[r]) * A[r, c0 + j]
//
// With one split the block adds acc straight into S; with several it
// writes acc to partial[split] and pass 2 (stream_moments_reduce, one
// thread per output) sums the partials in ascending split order and
// adds the total into S.  One owner per output, no atomics: the result
// repeats bit for bit from run to run, and -fmad=false keeps each
// product and sum separately rounded, which is what the plain version
// (pint_tpu_torch.linalg.stream_moments_plain) does in the same order.
//
// Bound on an H100 (3.35 TB/s, fp64 34 TFLOP/s): A and w are read once
// and S read and written once: 8 (n c + n + 2 c (c - c0)) bytes against
// 2 n c (c - c0) operations.  The capture is bound by its bytes (~6.3 MB,
// ~1.9 us); the fold reads and writes the (K + P + 2)^2 packed matrix
// (~3.6 MB at c = 473, ~1.1 us) for 14 MFLOP (~0.4 us).  A simple kernel
// first: scalar fp64, a tile's rows staged once per split.

#include <cstdint>
#include <cuda_runtime.h>

#define K10_THREADS 256
#define K10_ROWS 32
#define K10_TI 64
#define K10_TJ 32

__global__ void __launch_bounds__(K10_THREADS)
stream_moments_partial(const double* __restrict__ A,
                       const double* __restrict__ w, double* __restrict__ S,
                       double* __restrict__ partial, int64_t n, int64_t c,
                       int64_t c0, int64_t lds, int64_t tiles_j) {
  __shared__ double ai[K10_ROWS][K10_TI];
  __shared__ double aj[K10_ROWS][K10_TJ];
  const int t = threadIdx.x;
  const int64_t split = blockIdx.x;
  const int64_t nsplit = gridDim.x;
  const int64_t cw = c - c0;
  const int64_t i0 = (int64_t)(blockIdx.y / tiles_j) * K10_TI;
  const int64_t j0 = (int64_t)(blockIdx.y % tiles_j) * K10_TJ;
  const int64_t row0 = split * K10_ROWS;
  for (int idx = t; idx < K10_ROWS * K10_TI; idx += K10_THREADS) {
    const int r = idx / K10_TI;
    const int col = idx % K10_TI;
    const int64_t row = row0 + r;
    const int64_t i = i0 + col;
    ai[r][col] = (row < n && i < c) ? __dmul_rn(A[row * c + i], w[row])
                                    : 0.0;
  }
  for (int idx = t; idx < K10_ROWS * K10_TJ; idx += K10_THREADS) {
    const int r = idx / K10_TJ;
    const int col = idx % K10_TJ;
    const int64_t row = row0 + r;
    const int64_t j = j0 + col;
    aj[r][col] = (row < n && j < cw) ? A[row * c + c0 + j] : 0.0;
  }
  __syncthreads();
  const int ti = t % 16;
  const int tj = t / 16;
  double acc[4][2];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    acc[a][0] = 0.0;
    acc[a][1] = 0.0;
  }
  for (int r = 0; r < K10_ROWS; ++r) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const double x = ai[r][ti + 16 * a];
#pragma unroll
      for (int b = 0; b < 2; ++b)
        acc[a][b] = __dadd_rn(acc[a][b], __dmul_rn(x, aj[r][tj + 16 * b]));
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int64_t i = i0 + ti + 16 * a;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int64_t j = j0 + tj + 16 * b;
      if (i < c && j < cw) {
        if (nsplit == 1) {
          S[i * lds + j] = __dadd_rn(S[i * lds + j], acc[a][b]);
        } else {
          partial[(split * c + i) * cw + j] = acc[a][b];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(K10_THREADS)
stream_moments_reduce(const double* __restrict__ partial,
                      double* __restrict__ S, int64_t c, int64_t c0,
                      int64_t lds, int64_t nsplit) {
  const int64_t cw = c - c0;
  const int64_t e = (int64_t)blockIdx.x * K10_THREADS + threadIdx.x;
  if (e >= c * cw) return;
  const int64_t i = e / cw;
  const int64_t j = e % cw;
  double acc = partial[e];
  for (int64_t s = 1; s < nsplit; ++s)
    acc = __dadd_rn(acc, partial[s * c * cw + e]);
  S[i * lds + j] = __dadd_rn(S[i * lds + j], acc);
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
  dim3 grid((unsigned)nsplit, (unsigned)(tiles_i * tiles_j));
  stream_moments_partial<<<grid, K10_THREADS, 0, stream>>>(
      A, w, S, partial, n, c, c0, lds, tiles_j);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  const int64_t blocks = (c * cw + K10_THREADS - 1) / K10_THREADS;
  stream_moments_reduce<<<(unsigned)blocks, K10_THREADS, 0, stream>>>(
      partial, S, c, c0, lds, nsplit);
  return (int)cudaGetLastError();
}
