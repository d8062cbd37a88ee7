// Kernel K9: the stretch move of half an ensemble against the other half.
//
// Replaces the elementwise work of pint_tpu/sampler.py:207 _stretch_half
// (:211-220), which pint_tpu/sampler.py:224 run_mcmc scans over steps
// (:266-285, the red-black split: the second half moves against the
// first half already moved).  The posterior call between the stages
// stays outside (the vmapped timing posterior, kernels K1 and K8).  One
// launcher, two stages:
//
// stage 0, propose, one thread per (walker w, coordinate k):
//   t = fma(a - 1, u_w, 1);  z_w = (t t) (1/a)
//   proposal_wk = fma(z_w, active_wk - other_jk, other_jk),  j = idx_w
// stage 1, accept:
//   a per-walker pass, one block whose threads take walkers w, w + 256,
//   ...: lnratio = fma(ndim - 1, log z_w, lnp_prop_w) - lnp_w,
//   accepted_w = log(u_acc_w) < lnratio (a NaN compares false: the move
//   is rejected), lnp_w = lnp_prop_w where accepted, and the number
//   accepted summed over the threads by a fixed halving tree into
//   count[0];
//   then one thread per (w, k): active_wk = proposal_wk where accepted.
//
// The association is the one XLA gives the reference's lines on the
// CPU: its multiply-adds contracted to fused multiply-adds and z's
// division by the constant a turned into a product with 1/a (checked bit
// for bit against jax.jit of _stretch_half).  The fma() calls are
// explicit; -fmad=false keeps every other product separately rounded.
// log() is CUDA's, the same function torch.log calls on the card, so the
// plain PyTorch version (pint_tpu_torch/sampler.py, which computes the
// fma exactly from error-free transforms) agrees bit for bit.
//
// Bound on an H100 (3.35 TB/s, 34 TFLOP/s fp64): a half-move of h
// walkers in d coordinates reads active, the gathered partners and the
// proposals (3 h d doubles) and a few doubles per walker, and writes the
// proposals and the accepted walkers (2 h d); ~8 operations per element.
// At the chain's shape (16 x 10) that is ~7 kB, 2 ns of bytes: each
// launch costs its ~2-3 us of launch latency, four per step.  At 4096 x
// 64 (~10.6 MB) the bytes bound it, ~3 us.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#define K9_THREADS 256

__global__ void __launch_bounds__(K9_THREADS)
stretch_propose_kernel(const double* __restrict__ active,
                       const double* __restrict__ other,
                       const double* __restrict__ u,
                       const int64_t* __restrict__ idx,
                       double* __restrict__ z,
                       double* __restrict__ proposal, int64_t h, int64_t nd,
                       double a, double inv_a) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h * nd) return;
  const int64_t w = i / nd;
  const int64_t k = i - w * nd;
  const double t = fma(a - 1.0, u[w], 1.0);
  const double zw = (t * t) * inv_a;
  const double o = other[idx[w] * nd + k];
  proposal[i] = fma(zw, active[i] - o, o);
  if (k == 0) z[w] = zw;
}

__global__ void __launch_bounds__(K9_THREADS)
stretch_decide_kernel(const double* __restrict__ z,
                      double* __restrict__ lnp,
                      const double* __restrict__ lnp_prop,
                      const double* __restrict__ u_acc,
                      uint8_t* __restrict__ accepted,
                      int64_t* __restrict__ count, int64_t h, int64_t nd) {
  __shared__ int64_t part[K9_THREADS];
  const double c = (double)(nd - 1);
  int64_t n = 0;
  for (int64_t w = threadIdx.x; w < h; w += K9_THREADS) {
    const double lnratio = fma(c, log(z[w]), lnp_prop[w]) - lnp[w];
    const bool acc = log(u_acc[w]) < lnratio;
    accepted[w] = acc ? 1 : 0;
    if (acc) lnp[w] = lnp_prop[w];
    n += acc ? 1 : 0;
  }
  part[threadIdx.x] = n;
  __syncthreads();
  for (int s = K9_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) count[0] = part[0];
}

__global__ void __launch_bounds__(K9_THREADS)
stretch_select_kernel(double* __restrict__ active,
                      const double* __restrict__ proposal,
                      const uint8_t* __restrict__ accepted, int64_t h,
                      int64_t nd) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h * nd) return;
  if (accepted[i / nd]) active[i] = proposal[i];
}

extern "C" int stretch_move_launch(
    int stage, double* active, const double* other, const double* u,
    const int64_t* idx, double* z, double* proposal, double* lnp,
    const double* lnp_prop, const double* u_acc, uint8_t* accepted,
    int64_t* count, int64_t h, int64_t nd, double a, double inv_a,
    cudaStream_t stream) {
  if (h <= 0 || nd <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((h * nd + K9_THREADS - 1) / K9_THREADS);
  if (stage == 0) {
    stretch_propose_kernel<<<blocks, K9_THREADS, 0, stream>>>(
        active, other, u, idx, z, proposal, h, nd, a, inv_a);
  } else if (stage == 1) {
    stretch_decide_kernel<<<1, K9_THREADS, 0, stream>>>(
        z, lnp, lnp_prop, u_acc, accepted, count, h, nd);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    stretch_select_kernel<<<blocks, K9_THREADS, 0, stream>>>(
        active, proposal, accepted, h, nd);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
