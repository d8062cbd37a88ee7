// Kernel K2: segment sums in a fixed order, for the ECORR epoch block.
//
// Replaces the jax.ops.segment_sum calls of pint_tpu/linalg.py:158
// _ut_dot (U^T y over the epoch block) and :191 _weighted_gram (its
// epoch-by-dense and epoch-diagonal blocks), which also serve
// :391 noise_gram_precompute.
//
//   out[s, c] = sum over rows r of segment s, in ascending r, of X[r, c]
//
// The segments come as a CSR built once on the host at prepare time:
// perm lists the rows of every segment (a stable argsort of the segment
// ids, so rows inside a segment stay in ascending order) and
// offsets[s] .. offsets[s+1] delimit segment s in perm.  Rows outside
// every epoch are simply absent from perm.
//
// Why by hand: index_add_/scatter_add_ on float64 CUDA tensors use
// atomics, so their summation order — and the last bits of the result —
// change from run to run.  Here each (segment, column) sum is owned by
// one thread that adds its rows serially from 0.0 in ascending row
// order: the result is deterministic and bit-identical to the CPU's
// sequential index_add_ (and to XLA's CPU segment_sum) on the same
// inputs.
//
// Bound on an H100 (3.35 TB/s): memory.  The function reads X once
// (N*M*8 B), perm and offsets (4N + 4(K_e+1) B) and writes K_e*M*8 B;
// at N = 10^4, M = 61 that is ~5 MB, ~1.5 us.  The design: one thread
// per (segment, column), neighbouring threads on neighbouring columns
// of the same row, so each row of a segment is read as one coalesced
// run of M doubles; the perm entry is an L1 broadcast across the row's
// threads.  At M = 1 only K_e threads run and the launch latency is the
// cost.  No atomics, no shared memory, nothing allocated.

#include <cstdint>
#include <cuda_runtime.h>

__global__ void segment_sum_kernel(const double* __restrict__ x,
                                   const int32_t* __restrict__ perm,
                                   const int32_t* __restrict__ offsets,
                                   double* __restrict__ out, int64_t k_e,
                                   int64_t m) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= k_e * m) return;
  const int64_t s = idx / m;
  const int64_t c = idx - s * m;
  const int32_t begin = offsets[s];
  const int32_t end = offsets[s + 1];
  double acc = 0.0;
  for (int32_t p = begin; p < end; ++p) {
    acc = __dadd_rn(acc, x[(int64_t)perm[p] * m + c]);
  }
  out[idx] = acc;
}

extern "C" int segment_sum_launch(const void* x, const void* perm,
                                  const void* offsets, void* out,
                                  int64_t k_e, int64_t m, void* stream) {
  const int threads = 128;
  const int64_t total = k_e * m;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  segment_sum_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const double*)x, (const int32_t*)perm, (const int32_t*)offsets,
      (double*)out, k_e, m);
  return (int)cudaGetLastError();
}
