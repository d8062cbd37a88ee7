// Kernel K9: the stretch move of an ensemble, one launch per gap between
// posterior calls.
//
// Replaces the elementwise work of pint_tpu/sampler.py:207 _stretch_half
// (:211-220), which pint_tpu/sampler.py:224 run_mcmc scans over steps
// (:266-285, the red-black split: the second half moves against the
// first half already moved).  The posterior call between the launches
// stays outside (the vmapped timing posterior, kernels K1 and K8).  One
// kernel with two flags:
//
// accept (the half whose posterior call just ended), per walker w:
//   lnratio = fma(ndim - 1, log z_w, lnp_prop_w) - lnp_w,
//   accepted_w = log(u_acc_w) < lnratio (a NaN compares false: the move
//   is rejected), lnp_w = lnp_prop_w where accepted; then per (w, k):
//   active_wk = proposal_wk where accepted; count[0] = the number
//   accepted;
// propose (the half whose posterior call comes next), per (w, k):
//   t = fma(a - 1, u_w, 1);  z_w = (t t) (1/a)
//   proposal_wk = fma(z_w, active_wk - o, o),  o = other_jk, j = idx_w.
// With both flags the proposing half's other is the accepting half, as
// it stands after the accept: the thread forms o = accepted_j ?
// proposal_jk : active_jk itself.  The select writes only entries it
// accepts and the propose reads active only where it rejects, so the
// two need no barrier between them.  sampler.run_chain launches it three
// times a step: propose half 0; accept half 0 and propose half 1; accept
// half 1.
//
// The grid is one cooperative launch of at most the co-resident blocks
// (the occupancy query, cached per device), with grid-stride loops.
// With accept there is one grid.sync() between the decisions and their
// use (the select, the partner's walker, the count); propose alone
// syncs nothing.  After the sync, block 0 counts the flags: an integer
// sum, exact in any order, and it needs nothing of count on entry.
// Indices are 32 bits: the launcher refuses h * ndim >= 2^31.
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
// Bound on an H100 (3.35 TB/s, 34 TFLOP/s fp64): the middle launch of a
// step reads the accepting half's proposals, the proposing half's
// walkers and the partners (3 h d doubles), writes the accepted walkers
// and the new proposals (2 h d) and a few doubles per walker; ~8
// operations per element.  At the chain's shape (16 x 10) a step moves
// ~10 kB, 3 ns of bytes: each launch costs its ~2-3 us of launch
// latency, three per step.  At 4096 x 64 the middle launch moves ~11 MB,
// ~3 us.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define K9_THREADS 256

struct StretchArgs {
  // the accepting half
  double* act_a;             // (h, nd) walkers, the accepted ones replaced
  double* lnp_a;             // (h,)    their lnp, likewise
  const double* prop_a;      // (h, nd) their proposals
  const double* z_a;         // (h,)    their stretch factors
  const double* lnp_prop_a;  // (h,)    the proposals' lnp
  const double* u_acc_a;     // (h,)    acceptance uniforms
  uint8_t* accepted;         // (h,)    the decisions (out)
  int64_t* count;            // (1,)    their number (out)
  // the proposing half
  const double* act_p;       // (h, nd) walkers
  const double* oth_p;       // (h, nd) the other half (act_a with accept)
  const double* u_p;         // (h,)    uniforms of z
  const int64_t* idx_p;      // (h,)    partner indices in [0, h)
  double* prop_p;            // (h, nd) proposals (out)
  double* z_p;               // (h,)    stretch factors (out)
  int h, nd, accept, propose;
  double a, inv_a;
};

__global__ void __launch_bounds__(K9_THREADS)
stretch_move_kernel(StretchArgs s) {
  const unsigned tid = blockIdx.x * K9_THREADS + threadIdx.x;
  const unsigned stride = gridDim.x * K9_THREADS;
  const unsigned h = (unsigned)s.h, nd = (unsigned)s.nd, n = h * nd;
  if (s.accept) {
    const double c = (double)(s.nd - 1);
    for (unsigned w = tid; w < h; w += stride) {
      const double lnratio = fma(c, log(s.z_a[w]), s.lnp_prop_a[w])
                             - s.lnp_a[w];
      const bool acc = log(s.u_acc_a[w]) < lnratio;
      s.accepted[w] = acc ? 1 : 0;
      if (acc) s.lnp_a[w] = s.lnp_prop_a[w];
    }
    cg::this_grid().sync();
    if (blockIdx.x == 0) {
      __shared__ int part[K9_THREADS / 32];
      int m = 0;
      for (unsigned w = threadIdx.x; w < h; w += K9_THREADS)
        m += s.accepted[w];
      for (int o = 16; o > 0; o >>= 1)
        m += __shfl_down_sync(0xffffffffu, m, o);
      if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
      __syncthreads();
      if (threadIdx.x == 0) {
        int total = 0;
        for (int i = 0; i < K9_THREADS / 32; ++i) total += part[i];
        s.count[0] = total;
      }
    }
  }
  const double am1 = s.a - 1.0;
  for (unsigned i = tid; i < n; i += stride) {
    const unsigned w = i / nd;
    const unsigned k = i - w * nd;
    if (s.accept && s.accepted[w]) s.act_a[i] = s.prop_a[i];
    if (s.propose) {
      const double t = fma(am1, s.u_p[w], 1.0);
      const double zw = (t * t) * s.inv_a;
      const unsigned p = (unsigned)s.idx_p[w];
      const unsigned j = p * nd + k;
      const double o = !s.accept ? s.oth_p[j]
                       : s.accepted[p] ? s.prop_a[j] : s.act_a[j];
      s.prop_p[i] = fma(zw, s.act_p[i] - o, o);
      if (k == 0) s.z_p[w] = zw;
    }
  }
}

// the co-resident blocks of stretch_move_kernel on the current device
static int co_resident_blocks() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, stretch_move_kernel, K9_THREADS, 0) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev) != cudaSuccess)
      return 0;
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

// the grid a launch at (h, nd) takes: min(ceil(h nd / 256), co-resident)
extern "C" int stretch_move_blocks(int64_t h, int64_t nd) {
  const int most = co_resident_blocks();
  const int64_t want = (h * nd + K9_THREADS - 1) / K9_THREADS;
  return want < most ? (int)want : most;
}

extern "C" int stretch_move_max_blocks() { return co_resident_blocks(); }

extern "C" int stretch_move_launch(
    int accept, int propose, double* act_a, double* lnp_a,
    const double* prop_a, const double* z_a, const double* lnp_prop_a,
    const double* u_acc_a, uint8_t* accepted, int64_t* count,
    const double* act_p, const double* oth_p, const double* u_p,
    const int64_t* idx_p, double* prop_p, double* z_p, int64_t h,
    int64_t nd, double a, double inv_a, cudaStream_t stream) {
  if (h <= 0 || nd <= 0 || h * nd >= ((int64_t)1 << 31)
      || !(accept || propose) || (accept && propose && oth_p != act_a))
    return (int)cudaErrorInvalidValue;
  const int blocks = stretch_move_blocks(h, nd);
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  StretchArgs s{act_a,  lnp_a, prop_a, z_a,  lnp_prop_a, u_acc_a,
                accepted, count, act_p, oth_p, u_p,      idx_p,
                prop_p, z_p,    (int)h, (int)nd, accept ? 1 : 0,
                propose ? 1 : 0, a, inv_a};
  void* params[] = {&s};
  return (int)cudaLaunchCooperativeKernel((const void*)stretch_move_kernel,
                                          dim3(blocks), dim3(K9_THREADS),
                                          params, 0, stream);
}
