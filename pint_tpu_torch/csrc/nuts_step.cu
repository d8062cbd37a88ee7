// Kernel K6: the elementwise work of one NUTS-class transition, one
// launch per gap between gradient calls.
//
// Replaces the masked leapfrog, energy, acceptance, divergence and
// dual-averaging arithmetic of pint_tpu/gw/hmc.py:357 _chunk_body's
// one_chain (:365-421), vmapped over chains.  The posterior gradient
// between the launches stays outside (kernels K5/K5b and the GW sector's
// LU); K6 is everything else.  One block per chain, its threads striding
// over the coordinates; three stages of one launcher, n_leap + 1 launches
// a draw (13 at 12 leapfrog steps):
//
// stage 0, before gradient 0: pre(0)
//   p = z / sqrt(inv_mass); ph = p + (0.5 eps) g; xn = x + (eps inv_mass) ph
// stage 1, between gradients i and i + 1 (i < n_leap - 1): post(i), pre(i + 1)
//   post(i): active = i < n_steps[c]; pn = ph + (0.5 eps) gn
//            (x1, p1, g1, lnp1) = active ? (xn, pn, gn, lnp_n) : unchanged
//   pre(i+1): ph = p1 + (0.5 eps) g1; xn = x1 + (eps inv_mass) ph
//   The same thread closes step i and opens step i + 1 for its (chain,
//   coordinate) element, from the values it holds in registers.
// stage 2, after the last gradient: post(n_leap - 1), then the draw's end
//   h0 = -lnp + 0.5 sum (p0 p0) inv_mass,  h1 = -lnp1 + 0.5 sum (p1 p1) inv_mass
//   dh = h0 - h1;  acc = isfinite(dh) ? exp(min(0, dh)) : 0
//   divergent = isnan(dh) or (-dh > 1000 and isfinite(lnp1))
//   accepted = log(u) < dh: (x, g, lnp) = (x1, g1, lnp1)
//   dual averaging while adapting; the next draw's step size.
//   Every thread forms its coordinates' kinetic terms and stages them in
//   shared memory, 256 at a time; thread 0 sums the terms of p0 and
//   thread 32 (1 in a one-warp block) those of p1, in ascending
//   coordinate order (the order of the plain version's _kinetic); thread
//   0 decides and does the dual averaging, the block copies the accepted
//   x and g.
// The draw-index scalars of the dual averaging (1 - 1/(t + t0),
// t + t0, sqrt(t) / gamma, t^-kappa, 1 - t^-kappa) come from the host,
// which knows the draw index without reading the device.
//
// Every product and sum is written in the reference's association and
// compiled with -fmad=false, and the kinetic energies are summed over
// coordinates in ascending order, so the plain PyTorch version, which
// does the same, agrees to the ulp of the math library's exp and log.
// Indices are 32 bits: the launcher refuses n_chains * n >= 2^31.
//
// Bound on an H100 SXM: at 16 chains x 138 coordinates a draw moves
// ~0.5 MB (state, momenta, 12 gradients and proposals), ~0.15 us of
// bytes; the work is a few operations per byte.  The launch floor
// (~2-3 us each, 13 a draw) bounds it, not the card.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#define THREADS 256

struct NutsArgs {
  double* x;            // (C, nd) chain state
  double* g;            // (C, nd) its gradient
  double* lnp;          // (C,)    its log posterior
  double* x1;           // (C, nd) trajectory position
  double* p1;           // (C, nd) trajectory momentum
  double* g1;           // (C, nd) trajectory gradient
  double* lnp1;         // (C,)    log posterior at the last active step
  double* xn;           // (C, nd) proposal the gradient is taken at
  double* ph;           // (C, nd) half-kicked momentum
  const double* gn;     // (C, nd) gradient at xn
  const double* lnp_n;  // (C,)    log posterior at xn
  const double* z;      // (C, nd) standard-normal momentum draw
  const int64_t* n_steps;  // (C,)
  const double* u;      // (C,)    acceptance uniform
  const double* inv_mass;  // (nd,)
  double* eps;          // (C,) step size of this draw (next draw's after 2)
  double* log_eps;      // (C,)
  double* hbar;         // (C,)
  double* log_eps_bar;  // (C,)
  const double* mu;     // (C,)
  double* acc;          // (C,) acceptance probability (out)
  uint8_t* divergent;   // (C,) (out)
  uint8_t* accepted;    // (C,) (out)
  double* eps_used;     // (C,) (out)
};

struct DrawEnd {  // stage 2's scalars
  int adapting, adapting_next;
  double target, c1, tt0, sq_over_gamma, eta, one_m_eta;
};

// post(step) for element i of chain c: (x1, p1, g1) after it, in
// registers and, where the chain is active, in memory
__device__ __forceinline__ void leap_post(const NutsArgs& a, int i,
                                          bool active, double e, double& x,
                                          double& p, double& g) {
  if (active) {
    g = a.gn[i];
    x = a.xn[i];
    p = a.ph[i] + (0.5 * e) * g;
    a.x1[i] = x;
    a.p1[i] = p;
    a.g1[i] = g;
  } else {
    x = a.x1[i];
    p = a.p1[i];
    g = a.g1[i];
  }
}

__device__ __forceinline__ void leap_pre(const NutsArgs& a, int i, int k,
                                         double e, double x, double p,
                                         double g) {
  const double h = p + (0.5 * e) * g;
  a.ph[i] = h;
  a.xn[i] = x + (e * a.inv_mass[k]) * h;
}

__global__ void __launch_bounds__(THREADS)
nuts_pre0_kernel(NutsArgs a, int n) {
  const int c = blockIdx.x;
  const double e = a.eps[c];
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int i = c * n + k;
    leap_pre(a, i, k, e, a.x[i], a.z[i] / sqrt(a.inv_mass[k]), a.g[i]);
  }
}

__global__ void __launch_bounds__(THREADS)
nuts_post_pre_kernel(NutsArgs a, int n, int step) {
  const int c = blockIdx.x;
  const bool active = step < a.n_steps[c];
  const double e = a.eps[c];
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int i = c * n + k;
    double x, p, g;
    leap_post(a, i, active, e, x, p, g);
    leap_pre(a, i, k, e, x, p, g);
  }
  if (active && threadIdx.x == 0) a.lnp1[c] = a.lnp_n[c];
}

__global__ void __launch_bounds__(THREADS)
nuts_post_end_kernel(NutsArgs a, int n, int step, DrawEnd d) {
  __shared__ double t0[THREADS], t1[THREADS];
  __shared__ double ke1;
  __shared__ int accept;
  const int c = blockIdx.x;
  const bool active = step < a.n_steps[c];
  const double e = a.eps[c];
  // thread 0 sums p0's terms, thread s1 (another warp's where there is
  // one) p1's
  const int s1 = blockDim.x > 32 ? 32 : 1;
  double sum = 0.0;
  for (int k0 = 0; k0 < n; k0 += blockDim.x) {
    const int k = k0 + threadIdx.x;
    if (k < n) {
      const int i = c * n + k;
      double x, p, g;
      leap_post(a, i, active, e, x, p, g);
      const double im = a.inv_mass[k];
      const double p0 = a.z[i] / sqrt(im);
      t0[threadIdx.x] = (p0 * p0) * im;
      t1[threadIdx.x] = (p * p) * im;
    }
    __syncthreads();
    const int m = min((int)blockDim.x, n - k0);
    if (threadIdx.x == 0) {
      for (int j = 0; j < m; ++j) sum += t0[j];
    } else if (threadIdx.x == s1) {
      for (int j = 0; j < m; ++j) sum += t1[j];
    }
    __syncthreads();
  }
  if (threadIdx.x == s1) ke1 = sum;
  __syncthreads();
  const double lnp1 = active ? a.lnp_n[c] : a.lnp1[c];
  if (threadIdx.x == 0) {
    const double h0 = -a.lnp[c] + 0.5 * sum;
    const double h1 = -lnp1 + 0.5 * ke1;
    const double dh = h0 - h1;
    const double acc = isfinite(dh) ? exp(fmin(0.0, dh)) : 0.0;
    const bool div = isnan(dh) || (-dh > 1000.0 && isfinite(lnp1));
    accept = log(a.u[c]) < dh;
    a.lnp1[c] = lnp1;
    if (accept) a.lnp[c] = lnp1;
    double le = a.log_eps[c], leb = a.log_eps_bar[c];
    if (d.adapting) {
      const double hb = d.c1 * a.hbar[c] + (d.target - acc) / d.tt0;
      le = a.mu[c] - d.sq_over_gamma * hb;
      leb = d.eta * le + d.one_m_eta * leb;
      a.hbar[c] = hb;
      a.log_eps[c] = le;
      a.log_eps_bar[c] = leb;
    }
    a.acc[c] = acc;
    a.divergent[c] = div ? 1 : 0;
    a.accepted[c] = accept ? 1 : 0;
    a.eps_used[c] = e;
    a.eps[c] = d.adapting_next ? exp(le) : exp(leb);
  }
  __syncthreads();
  if (accept) {
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const int i = c * n + k;
      a.x[i] = a.x1[i];
      a.g[i] = a.g1[i];
    }
  }
}

extern "C" int nuts_step_launch(
    int stage, const void* const* ptrs, int64_t n_chains, int64_t n,
    int64_t step, int adapting, int adapting_next, double target, double c1,
    double tt0, double sq_over_gamma, double eta, double one_m_eta,
    cudaStream_t stream) {
  if (n_chains <= 0 || n <= 0 || n_chains * n >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  NutsArgs a;
  static_assert(sizeof(NutsArgs) == 24 * sizeof(void*),
                "NutsArgs is the launcher's 24 pointers in order");
  memcpy(&a, ptrs, sizeof(NutsArgs));
  const int threads = n < THREADS ? (int)((n + 31) / 32 * 32) : THREADS;
  const unsigned blocks = (unsigned)n_chains;
  if (stage == 0) {
    nuts_pre0_kernel<<<blocks, threads, 0, stream>>>(a, (int)n);
  } else if (stage == 1) {
    nuts_post_pre_kernel<<<blocks, threads, 0, stream>>>(a, (int)n,
                                                         (int)step);
  } else if (stage == 2) {
    DrawEnd d{adapting, adapting_next, target, c1,
              tt0,      sq_over_gamma, eta,    one_m_eta};
    nuts_post_end_kernel<<<blocks, threads, 0, stream>>>(a, (int)n,
                                                         (int)step, d);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
