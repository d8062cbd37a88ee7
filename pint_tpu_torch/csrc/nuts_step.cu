// Kernel K6: the elementwise work of one NUTS-class transition.
//
// Replaces the masked leapfrog, energy, acceptance, divergence and
// dual-averaging arithmetic of pint_tpu/gw/hmc.py:357 _chunk_body's
// one_chain (:365-421), vmapped over chains.  The posterior gradient
// between the half-kicks stays outside (kernels K5/K5b and the GW
// sector's LU); K6 is everything else, in three stages of one launcher:
//
// stage 0, before gradient i, one thread per (chain, coordinate):
//   i == 0: p = z / sqrt(inv_mass) and the trajectory starts at the
//           chain's state (x, g); else at (x1, p1, g1)
//   ph = p + (0.5 eps) g,   xn = x + (eps inv_mass) ph
// stage 1, after gradient i (lnp_n, gn at xn), the same threads:
//   active = i < n_steps[c];   pn = ph + (0.5 eps) gn
//   (x1, p1, g1, lnp1) = active ? (xn, pn, gn, lnp_n) : unchanged
// stage 2, once per draw, one thread per chain:
//   h0 = -lnp + 0.5 sum (p0 p0) inv_mass,  h1 = -lnp1 + 0.5 sum (p1 p1) inv_mass
//   dh = h0 - h1;  acc = isfinite(dh) ? exp(min(0, dh)) : 0
//   divergent = isnan(dh) or (-dh > 1000 and isfinite(lnp1))
//   accepted = log(u) < dh: (x, g, lnp) = (x1, g1, lnp1)
//   dual averaging while adapting; the next draw's step size.
// The draw-index scalars of the dual averaging (1 - 1/(t + t0),
// t + t0, sqrt(t) / gamma, t^-kappa, 1 - t^-kappa) come from the host,
// which knows the draw index without reading the device.
//
// Every product and sum is written in the reference's association and
// compiled with -fmad=false, and the kinetic energies are summed over
// coordinates in ascending order, so the plain PyTorch version, which
// does the same, agrees to the ulp of the math library's exp and log.
//
// Bound on an H100 SXM: at 16 chains x 138 coordinates a draw moves
// ~0.5 MB (state, momenta, 12 gradients and proposals), ~0.15 us of
// bytes; the work is a few operations per byte.  It is 2 launches per
// leapfrog step and 1 per draw, so the launch floor (~2-3 us each)
// bounds it, not the card.

#include <cmath>
#include <cstdint>
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

__global__ void nuts_pre_kernel(NutsArgs a, int64_t step, int64_t n) {
  const int64_t c = blockIdx.x;
  const double e = a.eps[c];
  for (int64_t k = threadIdx.x; k < n; k += blockDim.x) {
    const int64_t i = c * n + k;
    double x, p, g;
    if (step == 0) {
      x = a.x[i];
      g = a.g[i];
      p = a.z[i] / sqrt(a.inv_mass[k]);
    } else {
      x = a.x1[i];
      g = a.g1[i];
      p = a.p1[i];
    }
    const double h = p + (0.5 * e) * g;
    a.ph[i] = h;
    a.xn[i] = x + (e * a.inv_mass[k]) * h;
  }
}

__global__ void nuts_post_kernel(NutsArgs a, int64_t step, int64_t n) {
  const int64_t c = blockIdx.x;
  if (!(step < a.n_steps[c])) return;  // inactive: nothing moves
  const double e = a.eps[c];
  for (int64_t k = threadIdx.x; k < n; k += blockDim.x) {
    const int64_t i = c * n + k;
    const double gk = a.gn[i];
    a.x1[i] = a.xn[i];
    a.p1[i] = a.ph[i] + (0.5 * e) * gk;
    a.g1[i] = gk;
  }
  if (threadIdx.x == 0) a.lnp1[c] = a.lnp_n[c];
}

__global__ void nuts_end_kernel(NutsArgs a, int64_t n, int64_t n_chains,
                                int adapting, int adapting_next,
                                double target, double c1, double tt0,
                                double sq_over_gamma, double eta,
                                double one_m_eta) {
  const int64_t c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chains) return;
  double ke0 = 0.0, ke1 = 0.0;
  for (int64_t k = 0; k < n; ++k) {
    const double p0 = a.z[c * n + k] / sqrt(a.inv_mass[k]);
    ke0 += (p0 * p0) * a.inv_mass[k];
  }
  for (int64_t k = 0; k < n; ++k) {
    const double p1 = a.p1[c * n + k];
    ke1 += (p1 * p1) * a.inv_mass[k];
  }
  const double lnp1 = a.lnp1[c];
  const double h0 = -a.lnp[c] + 0.5 * ke0;
  const double h1 = -lnp1 + 0.5 * ke1;
  const double dh = h0 - h1;
  const double acc = isfinite(dh) ? exp(fmin(0.0, dh)) : 0.0;
  const bool div = isnan(dh) || (-dh > 1000.0 && isfinite(lnp1));
  const bool accept = log(a.u[c]) < dh;
  if (accept) {
    for (int64_t k = 0; k < n; ++k) {
      a.x[c * n + k] = a.x1[c * n + k];
      a.g[c * n + k] = a.g1[c * n + k];
    }
    a.lnp[c] = lnp1;
  }
  double le = a.log_eps[c], leb = a.log_eps_bar[c];
  if (adapting) {
    const double hb = c1 * a.hbar[c] + (target - acc) / tt0;
    le = a.mu[c] - sq_over_gamma * hb;
    leb = eta * le + one_m_eta * leb;
    a.hbar[c] = hb;
    a.log_eps[c] = le;
    a.log_eps_bar[c] = leb;
  }
  a.acc[c] = acc;
  a.divergent[c] = div ? 1 : 0;
  a.accepted[c] = accept ? 1 : 0;
  a.eps_used[c] = a.eps[c];
  a.eps[c] = adapting_next ? exp(le) : exp(leb);
}

extern "C" int nuts_step_launch(
    int stage, double* x, double* g, double* lnp, double* x1, double* p1,
    double* g1, double* lnp1, double* xn, double* ph, const double* gn,
    const double* lnp_n, const double* z, const int64_t* n_steps,
    const double* u, const double* inv_mass, double* eps, double* log_eps,
    double* hbar, double* log_eps_bar, const double* mu, double* acc,
    uint8_t* divergent, uint8_t* accepted, double* eps_used,
    int64_t n_chains, int64_t n, int64_t step, int adapting,
    int adapting_next, double target, double c1, double tt0,
    double sq_over_gamma, double eta, double one_m_eta,
    cudaStream_t stream) {
  NutsArgs a{x,  g,       lnp,      x1,   p1,    g1,          lnp1,
             xn, ph,      gn,       lnp_n, z,    n_steps,     u,
             inv_mass,    eps,      log_eps, hbar, log_eps_bar, mu,
             acc, divergent, accepted, eps_used};
  const int threads = n < THREADS ? (int)((n + 31) / 32 * 32) : THREADS;
  if (stage == 0) {
    nuts_pre_kernel<<<(unsigned)n_chains, threads, 0, stream>>>(a, step, n);
  } else if (stage == 1) {
    nuts_post_kernel<<<(unsigned)n_chains, threads, 0, stream>>>(a, step, n);
  } else if (stage == 2) {
    const unsigned blocks = (unsigned)((n_chains + 127) / 128);
    nuts_end_kernel<<<blocks, 128, 0, stream>>>(
        a, n, n_chains, adapting, adapting_next, target, c1, tt0,
        sq_over_gamma, eta, one_m_eta);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
