// Kernels K12 and K12b: the weighted photon log-likelihood of a light-curve
// template (a mixture of wrapped peaks over a uniform background) and its
// backward.
//
// Replaces pint_tpu/templates.py:525 LCTemplate.lnlike_fn (the density of
// :511 and the clamped log-sum of :531-538) and, for K12b, jax.grad of it
// (pint_tpu/templates.py:570 LCFitter._val_grad).  The MCMC posterior of
// pint_tpu/mcmc_fitter.py:102 reaches the same sum through the template's
// density or the binned profile (:79-90).
//
// Per walker w (a row of phases and a row of template parameters, either
// of which may be shared by every walker through a row stride of 0) and
// photon i:
//   phi = frac[w, i], floor-mod 1 when `wrap` (torch's and jnp's `%`);
//   f   = bg_w + sum_c norm_c dens_c(phi)    (components in order, each
//          product and sum separately rounded, as LCTemplate.density)
//   x   = w_i f + (1 - w_i)   (or f without weights)
//   lnL_w = sum_i log(max(x, 1e-300)).
// The binned profile (nbins > 0, no components): f = bins[clip(int((phi
// mod 1) nbins), 0, nbins - 1)], the profile already divided by its mean.
//
// The per-walker scalar work stays in torch before the launch, so that
// autograd chains through it: the background 1 - sum(norms), sigma
// sqrt(2 pi), sinh and cosh of 2 pi gamma, i0e(kappa) and the two-sided
// weights 2 w1 / (w1 + w2).  Each component reaches the kernel as a type
// code and a packed row of 8 doubles:
//   0 LCGaussian     [norm, loc, sigma, sigma sqrt(2 pi)]
//   1 LCLorentzian   [norm, loc, sinh(2 pi g), cosh(2 pi g)]
//   2 LCVonMises     [norm, loc, kappa, i0e(kappa)]
//   3 LCGaussian2    [norm, loc, s1, s2, s1 sqrt(2 pi), s2 sqrt(2 pi),
//                     2 s1 / (s1 + s2), 2 s2 / (s1 + s2)]
//   4 LCLorentzian2  [norm, loc, sinh 1, cosh 1, sinh 2, cosh 2, a1, a2]
// The Gaussians sum all 7 wraps k = -3..3 as the reference does.
//
// K12 (photon_lnlike_launch), two kernels a call: grid (blocks of 2048
// photons, walkers), 256 threads each taking 8 photons in a fixed order,
// a fixed tree over the block's 256 sums, one partial per block; then one
// thread per walker adds its blocks' partials in order.  The result is
// bit-identical from run to run.  With `density` set it writes f per
// (walker, photon) instead (LCTemplate.density on the card), one kernel.
//
// K12b (photon_lnlike_bwd_launch): d lnL_w / d(bg, packed row) without the
// incoming cotangent, sum_i g_i df_i/dtheta with g_i = w_i / x_i (1 / x_i
// without weights) and g_i = 0 where the clamp holds (jnp.maximum's
// gradient below 1e-300).  Same grid; each thread keeps its 8 photons'
// phases and g in registers, then per component adds its 8 derivative
// slots over them, and the block reduces the 8 slots by a fixed tree; a
// second kernel adds the partials per (walker, slot) in order.
//
// Bound on an H100 (3.35 TB/s, 34 TFLOP/s fp64), counted by chip_smoke.py's
// K12_OPS and K12B_OPS (exp and log 20 operations, sin or cos 24, a
// division 8): at the MCMC's 16 walkers x 10^5 photons of the
// Gaussian + two-sided Lorentzian + von Mises template, K12 reads 12.8 MB
// of phases and 0.8 MB of weights (~4 us) and does ~370 fp64 operations
// per (walker, photon), 5.9e8 in all (~17 us), so it is bound by
// operations; K12b does ~540 per (walker, photon) (~25 us).  A simple
// kernel: no pruning of wraps, no shared staging of the parameters (a
// uniform read, cached).

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

#define K12_THREADS 256
#define K12_PER 8
#define K12_CHUNK (K12_THREADS * K12_PER)
#define K12_ROW 8
#define K12_NWRAP 3
#define K12_TWO_PI 6.283185307179586

enum { T_GAUSS = 0, T_LOR = 1, T_VM = 2, T_GAUSS2 = 3, T_LOR2 = 4 };

struct K12Args {
  const double* frac;     // (Wp, N) phases
  int64_t frac_rs;        // row stride (0: one row for every walker)
  const double* weights;  // (N,) or null
  const int32_t* types;   // (C,)
  const double* params;   // (Wq, C, 8)
  int64_t par_rs;         // row stride (0: shared)
  const double* bg;       // (Wq,)
  int64_t bg_rs;          // stride (0: shared)
  const double* bins;     // (nbins,) or null
  int nbins, C, wrap;
  int64_t W, N, nblk;
};

__device__ __forceinline__ double floor_mod1(double x) {
  // torch.remainder(x, 1.0) and jnp.remainder: fmod, then + 1 where the
  // remainder is negative
  double m = fmod(x, 1.0);
  if (m != 0.0 && m < 0.0) m = m + 1.0;
  return m;
}

__device__ __forceinline__ double wrapped_gauss(double t, double s,
                                                double c) {
  double acc = 0.0;
  for (int k = -K12_NWRAP; k <= K12_NWRAP; ++k) {
    double z = (t + (double)k) / s;
    acc = acc + exp(-0.5 * (z * z));
  }
  return acc / c;
}

// the two-sided split d = ((phi - loc + 0.5) mod 1) - 0.5
__device__ __forceinline__ double two_sided_d(double phi, double loc) {
  return floor_mod1((phi - loc) + 0.5) - 0.5;
}

__device__ double comp_density(int type, const double* p, double phi) {
  switch (type) {
    case T_GAUSS:
      return wrapped_gauss(phi - p[1], p[2], p[3]);
    case T_LOR:
      return p[2] / (p[3] - cos(K12_TWO_PI * (phi - p[1])));
    case T_VM: {
      double ang = K12_TWO_PI * (phi - p[1]);
      return exp(p[2] * (cos(ang) - 1.0)) / p[3];
    }
    case T_GAUSS2: {
      double d = two_sided_d(phi, p[1]);
      return d < 0.0 ? p[6] * wrapped_gauss(d, p[2], p[4])
                     : p[7] * wrapped_gauss(d, p[3], p[5]);
    }
    case T_LOR2: {
      double d = two_sided_d(phi, p[1]);
      double cd = cos(K12_TWO_PI * d);
      return d < 0.0 ? p[6] * (p[2] / (p[3] - cd))
                     : p[7] * (p[4] / (p[5] - cd));
    }
  }
  return nan("");
}

// df/dtheta of one component's packed row at phi (the norm included)
__device__ void comp_grad(int type, const double* p, double phi,
                          double* g) {
  for (int k = 0; k < K12_ROW; ++k) g[k] = 0.0;
  const double norm = p[0];
  switch (type) {
    case T_GAUSS: {
      double t = phi - p[1], s = p[2], c = p[3];
      double e0 = 0.0, e1 = 0.0, e2 = 0.0;
      for (int k = -K12_NWRAP; k <= K12_NWRAP; ++k) {
        double z = (t + (double)k) / s;
        double e = exp(-0.5 * (z * z));
        e0 = e0 + e;
        e1 = e1 + e * z;
        e2 = e2 + e * (z * z);
      }
      g[0] = e0 / c;
      g[1] = norm * ((e1 / s) / c);
      g[2] = norm * ((e2 / s) / c);
      g[3] = -norm * ((e0 / c) / c);
      return;
    }
    case T_LOR: {
      double a = K12_TWO_PI * (phi - p[1]);
      double den = p[3] - cos(a);
      double dens = p[2] / den;
      g[0] = dens;
      g[1] = norm * ((K12_TWO_PI * sin(a)) * (dens / den));
      g[2] = norm / den;
      g[3] = -norm * (dens / den);
      return;
    }
    case T_VM: {
      double ang = K12_TWO_PI * (phi - p[1]);
      double ca = cos(ang) - 1.0;
      double dens = exp(p[2] * ca) / p[3];
      g[0] = dens;
      g[1] = norm * (dens * (p[2] * (K12_TWO_PI * sin(ang))));
      g[2] = norm * (dens * ca);
      g[3] = -norm * (dens / p[3]);
      return;
    }
    case T_GAUSS2: {
      double d = two_sided_d(phi, p[1]);
      int r = d < 0.0 ? 0 : 1;
      double s = p[2 + r], c = p[4 + r], w = p[6 + r];
      double e0 = 0.0, e1 = 0.0, e2 = 0.0;
      for (int k = -K12_NWRAP; k <= K12_NWRAP; ++k) {
        double z = (d + (double)k) / s;
        double e = exp(-0.5 * (z * z));
        e0 = e0 + e;
        e1 = e1 + e * z;
        e2 = e2 + e * (z * z);
      }
      double core = e0 / c;
      double nw = norm * w;
      double gs = nw * ((e2 / s) / c), gc = -nw * (core / c);
      g[0] = w * core;
      g[1] = nw * ((e1 / s) / c);
      // constant indices keep g in registers
      if (r == 0) { g[2] = gs; g[4] = gc; g[6] = norm * core; }
      else { g[3] = gs; g[5] = gc; g[7] = norm * core; }
      return;
    }
    case T_LOR2: {
      double d = two_sided_d(phi, p[1]);
      int r = d < 0.0 ? 0 : 1;
      double sh = p[2 + 2 * r], ch = p[3 + 2 * r], w = p[6 + r];
      double a = K12_TWO_PI * d;
      double den = ch - cos(a);
      double core = sh / den;
      double nw = norm * w;
      double gsh = nw / den, gch = -nw * (core / den);
      g[0] = w * core;
      g[1] = nw * ((K12_TWO_PI * sin(a)) * (core / den));
      if (r == 0) { g[2] = gsh; g[3] = gch; g[6] = norm * core; }
      else { g[4] = gsh; g[5] = gch; g[7] = norm * core; }
      return;
    }
  }
}

__device__ double photon_f(const K12Args& A, int64_t w, double phi) {
  if (A.nbins > 0) {
    double q = floor_mod1(phi) * (double)A.nbins;
    int64_t j = (int64_t)q;  // truncation, as astype(int32)
    j = j < 0 ? 0 : (j > A.nbins - 1 ? A.nbins - 1 : j);
    return A.bins[j];
  }
  const double* pr = A.params + w * A.par_rs;
  double f = A.bg[w * A.bg_rs];
  for (int c = 0; c < A.C; ++c) {
    const double* p = pr + c * K12_ROW;
    f = f + p[0] * comp_density(A.types[c], p, phi);
  }
  return f;
}

__device__ __forceinline__ double photon_phi(const K12Args& A, int64_t w,
                                             int64_t i) {
  double phi = A.frac[w * A.frac_rs + i];
  return A.wrap ? floor_mod1(phi) : phi;
}

__device__ __forceinline__ double photon_x(const K12Args& A, int64_t i,
                                           double f) {
  if (A.weights == nullptr) return f;
  double wi = A.weights[i];
  return wi * f + (1.0 - wi);
}

// fixed tree over the block's K12_THREADS values; the sum lands in s[0]
__device__ void block_tree(double* s) {
  for (int h = K12_THREADS / 2; h > 0; h >>= 1) {
    __syncthreads();
    if ((int)threadIdx.x < h) s[threadIdx.x] = s[threadIdx.x] + s[threadIdx.x + h];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(K12_THREADS)
k12_partial(K12Args A, double* partial, double* dens_out, int density) {
  __shared__ double s[K12_THREADS];
  const int64_t w = blockIdx.y;
  const int64_t i0 = (int64_t)blockIdx.x * K12_CHUNK;
  double acc = 0.0;
  for (int j = 0; j < K12_PER; ++j) {
    int64_t i = i0 + (int64_t)j * K12_THREADS + threadIdx.x;
    if (i >= A.N) break;
    double f = photon_f(A, w, photon_phi(A, w, i));
    if (density) {
      dens_out[w * A.N + i] = f;
    } else {
      double x = photon_x(A, i, f);
      acc = acc + log(x < 1e-300 ? 1e-300 : x);
    }
  }
  if (density) return;
  s[threadIdx.x] = acc;
  block_tree(s);
  if (threadIdx.x == 0) partial[w * A.nblk + blockIdx.x] = s[0];
}

// out[r] = sum_b partial[r * nblk * q + b * q + k] over b in order, for
// every (row r, slot k): one thread each
__global__ void k12_reduce(const double* partial, double* out, int64_t rows,
                           int64_t nblk, int64_t q) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * q) return;
  int64_t r = t / q, k = t % q;
  const double* p = partial + r * nblk * q + k;
  double acc = 0.0;
  for (int64_t b = 0; b < nblk; ++b) acc = acc + p[b * q];
  out[t] = acc;
}

__global__ void __launch_bounds__(K12_THREADS)
k12b_partial(K12Args A, double* partial) {
  __shared__ double s[K12_ROW * K12_THREADS];
  const int64_t w = blockIdx.y;
  const int64_t i0 = (int64_t)blockIdx.x * K12_CHUNK;
  const int64_t q = 1 + (int64_t)A.C * K12_ROW;
  double* out = partial + (w * A.nblk + blockIdx.x) * q;
  double phis[K12_PER], gs[K12_PER];
  double gsum = 0.0;
  for (int j = 0; j < K12_PER; ++j) {
    int64_t i = i0 + (int64_t)j * K12_THREADS + threadIdx.x;
    gs[j] = 0.0;
    phis[j] = 0.0;
    if (i >= A.N) continue;
    double phi = photon_phi(A, w, i);
    double x = photon_x(A, i, photon_f(A, w, phi));
    double num = A.weights == nullptr ? 1.0 : A.weights[i];
    gs[j] = x > 1e-300 ? num / x : 0.0;
    phis[j] = phi;
    gsum = gsum + gs[j];
  }
  // the background: df/dbg = 1
  s[threadIdx.x] = gsum;
  block_tree(s);
  if (threadIdx.x == 0) out[0] = s[0];
  const double* pr = A.params + w * A.par_rs;
  for (int c = 0; c < A.C; ++c) {
    const double* p = pr + c * K12_ROW;
    const int type = A.types[c];
    double acc[K12_ROW], g[K12_ROW];
    for (int k = 0; k < K12_ROW; ++k) acc[k] = 0.0;
    for (int j = 0; j < K12_PER; ++j) {
      int64_t i = i0 + (int64_t)j * K12_THREADS + threadIdx.x;
      if (i >= A.N) break;
      comp_grad(type, p, phis[j], g);
      for (int k = 0; k < K12_ROW; ++k) acc[k] = acc[k] + gs[j] * g[k];
    }
    __syncthreads();  // the previous component's s[] has been read
    for (int k = 0; k < K12_ROW; ++k) s[k * K12_THREADS + threadIdx.x] = acc[k];
    for (int h = K12_THREADS / 2; h > 0; h >>= 1) {
      __syncthreads();
      if ((int)threadIdx.x < h)
        for (int k = 0; k < K12_ROW; ++k)
          s[k * K12_THREADS + threadIdx.x] =
              s[k * K12_THREADS + threadIdx.x] +
              s[k * K12_THREADS + threadIdx.x + h];
    }
    __syncthreads();
    if ((int)threadIdx.x < K12_ROW)
      out[1 + c * K12_ROW + threadIdx.x] = s[threadIdx.x * K12_THREADS];
  }
}

static K12Args make_args(const void* frac, int64_t frac_rs,
                         const void* weights, const void* types, int64_t C,
                         const void* params, int64_t par_rs, const void* bg,
                         int64_t bg_rs, const void* bins, int64_t nbins,
                         int64_t wrap, int64_t W, int64_t N) {
  K12Args A;
  A.frac = (const double*)frac;
  A.frac_rs = frac_rs;
  A.weights = (const double*)weights;
  A.types = (const int32_t*)types;
  A.params = (const double*)params;
  A.par_rs = par_rs;
  A.bg = (const double*)bg;
  A.bg_rs = bg_rs;
  A.bins = (const double*)bins;
  A.nbins = (int)nbins;
  A.C = (int)C;
  A.wrap = (int)wrap;
  A.W = W;
  A.N = N;
  A.nblk = (N + K12_CHUNK - 1) / K12_CHUNK;
  return A;
}

extern "C" int64_t photon_lnlike_blocks(int64_t n) {
  return (n + K12_CHUNK - 1) / K12_CHUNK;
}

// K12: lnL (W,) into out, or with density = 1 f (W, N) into out; partial
// is (W, nblk) scratch
extern "C" int photon_lnlike_launch(
    const void* frac, int64_t frac_rs, const void* weights,
    const void* types, int64_t C, const void* params, int64_t par_rs,
    const void* bg, int64_t bg_rs, const void* bins, int64_t nbins,
    int64_t wrap, int64_t density, void* partial, void* out, int64_t W,
    int64_t N, void* stream) {
  K12Args A = make_args(frac, frac_rs, weights, types, C, params, par_rs,
                        bg, bg_rs, bins, nbins, wrap, W, N);
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned)A.nblk, (unsigned)W);
  k12_partial<<<grid, K12_THREADS, 0, st>>>(A, (double*)partial,
                                            (double*)out, (int)density);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || density) return (int)err;
  k12_reduce<<<(unsigned)((W + 127) / 128), 128, 0, st>>>(
      (const double*)partial, (double*)out, W, A.nblk, 1);
  return (int)cudaGetLastError();
}

// K12b: (W, 1 + 8 C) of d lnL_w / d(bg, packed rows) into out; partial is
// (W, nblk, 1 + 8 C) scratch
extern "C" int photon_lnlike_bwd_launch(
    const void* frac, int64_t frac_rs, const void* weights,
    const void* types, int64_t C, const void* params, int64_t par_rs,
    const void* bg, int64_t bg_rs, int64_t wrap, void* partial, void* out,
    int64_t W, int64_t N, void* stream) {
  K12Args A = make_args(frac, frac_rs, weights, types, C, params, par_rs,
                        bg, bg_rs, nullptr, 0, wrap, W, N);
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned)A.nblk, (unsigned)W);
  k12b_partial<<<grid, K12_THREADS, 0, st>>>(A, (double*)partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t q = 1 + C * K12_ROW;
  k12_reduce<<<(unsigned)((W * q + 127) / 128), 128, 0, st>>>(
      (const double*)partial, (double*)out, W, A.nblk, q);
  return (int)cudaGetLastError();
}
