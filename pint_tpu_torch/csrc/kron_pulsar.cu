// Kernels K5 and K5b: the per-pulsar capacity stage of the
// kron-structured PTA likelihood, forward and backward.
//
// Replaces pint_tpu/linalg.py:667 kron_chi2_logdet_pre's per-pulsar
// `one` (vmapped over pulsars at :701-713, and over chains by
// pint_tpu/gw/hmc.py's jax.vmap), and its jax.grad.
//
// K5, forward.  One block per (chain, pulsar), with the pulsar's grams
// g_uu (nb, nb), g_uf (nb, m2), g_ff (m2, m2), b_u (nb), b_f (m2), rr,
// ld_white shared by every chain and the chain's weights phi (nb):
//
//   cap  = g_uu + diag(1 / max(phi, 1e-30))
//   L    = chol(cap)                      (right-looking, in shared)
//   X    = cap^-1 [b_u | g_uf]            (forward, back substitution)
//   chi2 = rr - b_u . x_u
//   x_a  = b_f - g_uf^T x_u
//   M_a  = g_ff - g_uf^T X_uf
//   ld_a = ld_white + sum log max(phi, 1e-30) + 2 sum log L_kk
//
// and writes L and X for the backward.  A pivot that is not > 0 (or
// NaN) makes it NaN, so every output of the block is NaN, as
// jax.scipy.linalg.cho_factor's is.
//
// K5b, backward, only through phi.  With dcap = -diag(dphi / phi^2),
// one block per (chain, pulsar) forms W = L^-1 in shared memory and
//
//   dphi_k = gld / phi_k - (1 / phi_k^2) [gchi x_u[k]^2
//            + x_u[k] sum_i gx_i X_uf[k,i]
//            + sum_ij gM_ij X_uf[k,i] X_uf[k,j] + gld (cap^-1)_kk]
//
// with (cap^-1)_kk = sum_{i >= k} W_ik^2; a weight below the 1e-30
// floor gets 0, as the clamp gives.
//
// Order: every sum runs in ascending index order in one thread, and
// each shared entry is updated by one thread per elimination step, so
// both kernels are bit-identical from run to run.  -fmad=false keeps
// every product and sum separately rounded.
//
// Bound on an H100 SXM: at 16 chains x 68 pulsars, nb = 63, m2 = 28,
// K5 reads the grams once (3.6 MB) and phi (0.55 MB) and writes
// L and X (50 MB) and the outputs (7 MB): ~18 us of bytes.  Its
// operations, per block nb^3/3 (Cholesky) + 2 nb^2 (1 + m2) (solves)
// + 2 nb m2^2 (M_a), ~0.4 MFLOP, 0.4 GFLOP in all, ~6 us on the fp64
// tensor cores: bytes bound it.  The design is the simple one: a
// 256-thread block walks nb elimination steps with a barrier each,
// so it is latency-bound (~nb * 3 barriers), not bandwidth-bound.
// Shared memory: 8 (nb^2 + nb (1 + m2)) bytes, 46 kB at nb = 63 -- the
// launcher raises the dynamic limit above 48 kB for wider pulsars.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#define THREADS 256
#define PHI_FLOOR 1e-30

__device__ __forceinline__ double floored(double v) {
  // max(v, floor) that keeps NaN, as torch.clamp does
  return v < PHI_FLOOR ? PHI_FLOOR : v;
}

__global__ void kron_pulsar_fwd_kernel(
    const double* __restrict__ phi, const double* __restrict__ g_uu,
    const double* __restrict__ g_uf, const double* __restrict__ g_ff,
    const double* __restrict__ b_u, const double* __restrict__ b_f,
    const double* __restrict__ rr, const double* __restrict__ ld_white,
    double* __restrict__ chi2, double* __restrict__ x_out,
    double* __restrict__ m_out, double* __restrict__ ld_out,
    double* __restrict__ L_out, double* __restrict__ X_out, int64_t n_psr,
    int64_t nb, int64_t m2) {
  extern __shared__ double smem[];
  const int64_t blk = blockIdx.x;  // chain * n_psr + pulsar
  const int64_t p = blk % n_psr;
  const int64_t R = 1 + m2;
  double* A = smem;            // (nb, nb) capacity, then L (lower)
  double* Y = smem + nb * nb;  // (nb, R) right-hand sides, then X
  const double* ph = phi + blk * nb;
  const double* G = g_uu + p * nb * nb;
  const double* GF = g_uf + p * nb * m2;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int64_t idx = tid; idx < nb * nb; idx += nt) {
    const int64_t i = idx / nb, j = idx % nb;
    double v = G[idx];
    if (i == j) v = v + 1.0 / floored(ph[i]);
    A[idx] = v;
  }
  for (int64_t idx = tid; idx < nb * R; idx += nt) {
    const int64_t i = idx / R, c = idx % R;
    Y[idx] = c == 0 ? b_u[p * nb + i] : GF[i * m2 + c - 1];
  }
  // Cholesky, right-looking: column j, then the trailing update
  for (int64_t j = 0; j < nb; ++j) {
    __syncthreads();
    if (tid == 0) {
      const double d = A[j * nb + j];
      A[j * nb + j] =
          d > 0.0 ? sqrt(d) : __longlong_as_double(0x7ff8000000000000LL);
    }
    __syncthreads();
    const double s = A[j * nb + j];
    for (int64_t i = j + 1 + tid; i < nb; i += nt) A[i * nb + j] /= s;
    __syncthreads();
    const int64_t n = nb - j - 1;
    for (int64_t idx = tid; idx < n * n; idx += nt) {
      const int64_t i = j + 1 + idx / n, k = j + 1 + idx % n;
      if (k <= i) A[i * nb + k] -= A[i * nb + j] * A[k * nb + j];
    }
  }
  // forward substitution L Y = B, row by row
  for (int64_t i = 0; i < nb; ++i) {
    __syncthreads();
    const double d = A[i * nb + i];
    for (int64_t c = tid; c < R; c += nt) Y[i * R + c] /= d;
    __syncthreads();
    for (int64_t idx = tid; idx < (nb - i - 1) * R; idx += nt) {
      const int64_t k = i + 1 + idx / R, c = idx % R;
      Y[k * R + c] -= A[k * nb + i] * Y[i * R + c];
    }
  }
  // back substitution L^T X = Y, row by row from the last
  for (int64_t i = nb - 1; i >= 0; --i) {
    __syncthreads();
    const double d = A[i * nb + i];
    for (int64_t c = tid; c < R; c += nt) Y[i * R + c] /= d;
    __syncthreads();
    for (int64_t idx = tid; idx < i * R; idx += nt) {
      const int64_t k = idx / R, c = idx % R;
      Y[k * R + c] -= A[i * nb + k] * Y[i * R + c];
    }
  }
  __syncthreads();
  double* Lg = L_out + blk * nb * nb;
  for (int64_t idx = tid; idx < nb * nb; idx += nt) {
    const int64_t i = idx / nb, j = idx % nb;
    Lg[idx] = j <= i ? A[idx] : 0.0;
  }
  double* Xg = X_out + blk * nb * R;
  for (int64_t idx = tid; idx < nb * R; idx += nt) Xg[idx] = Y[idx];
  // x_a and M_a: one thread per entry, sums over k ascending
  for (int64_t idx = tid; idx < m2 + m2 * m2; idx += nt) {
    if (idx < m2) {
      const int64_t i = idx;
      double acc = 0.0;
      for (int64_t k = 0; k < nb; ++k) acc += GF[k * m2 + i] * Y[k * R];
      x_out[blk * m2 + i] = b_f[p * m2 + i] - acc;
    } else {
      const int64_t e = idx - m2, i = e / m2, j = e % m2;
      double acc = 0.0;
      for (int64_t k = 0; k < nb; ++k)
        acc += GF[k * m2 + i] * Y[k * R + 1 + j];
      m_out[blk * m2 * m2 + e] = g_ff[p * m2 * m2 + e] - acc;
    }
  }
  if (tid == 0) {
    double acc = 0.0;
    for (int64_t k = 0; k < nb; ++k) acc += b_u[p * nb + k] * Y[k * R];
    chi2[blk] = rr[p] - acc;
    double s1 = 0.0, s2 = 0.0;
    for (int64_t k = 0; k < nb; ++k) s1 += log(floored(ph[k]));
    for (int64_t k = 0; k < nb; ++k) s2 += log(A[k * nb + k]);
    ld_out[blk] = ld_white[p] + s1 + 2.0 * s2;
  }
}

__global__ void kron_pulsar_bwd_kernel(
    const double* __restrict__ phi, const double* __restrict__ L,
    const double* __restrict__ X, const double* __restrict__ gchi,
    const double* __restrict__ gx, const double* __restrict__ gm,
    const double* __restrict__ gld, double* __restrict__ gphi, int64_t nb,
    int64_t m2) {
  extern __shared__ double smem[];
  const int64_t blk = blockIdx.x;
  const int64_t R = 1 + m2;
  double* W = smem;            // (nb, nb) L^-1, lower
  double* T = smem + nb * nb;  // (nb, m2) T[k, i] = sum_j gM_ij X_uf[k, j]
  const double* Lb = L + blk * nb * nb;
  const double* Xb = X + blk * nb * R;
  const double* gmb = gm + blk * m2 * m2;
  const double* gxb = gx + blk * m2;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int64_t idx = tid; idx < nb * nb; idx += nt)
    W[idx] = (idx / nb == idx % nb) ? 1.0 : 0.0;
  // L W = I, row by row; W stays lower triangular
  for (int64_t i = 0; i < nb; ++i) {
    __syncthreads();
    const double d = Lb[i * nb + i];
    for (int64_t c = tid; c <= i; c += nt) W[i * nb + c] /= d;
    __syncthreads();
    const int64_t w = i + 1;
    for (int64_t idx = tid; idx < (nb - i - 1) * w; idx += nt) {
      const int64_t k = i + 1 + idx / w, c = idx % w;
      W[k * nb + c] -= Lb[k * nb + i] * W[i * nb + c];
    }
  }
  for (int64_t idx = tid; idx < nb * m2; idx += nt) {
    const int64_t k = idx / m2, i = idx % m2;
    double acc = 0.0;
    for (int64_t j = 0; j < m2; ++j)
      acc += gmb[i * m2 + j] * Xb[k * R + 1 + j];
    T[idx] = acc;
  }
  __syncthreads();
  const double gc = gchi[blk];
  const double gl = gld[blk];
  for (int64_t k = tid; k < nb; k += nt) {
    const double v = phi[blk * nb + k];
    if (!(v >= PHI_FLOOR)) {
      gphi[blk * nb + k] = 0.0;
      continue;
    }
    const double xu = Xb[k * R];
    double q = 0.0, s = 0.0, dk = 0.0;
    for (int64_t i = 0; i < m2; ++i) q += gxb[i] * Xb[k * R + 1 + i];
    for (int64_t i = 0; i < m2; ++i) s += Xb[k * R + 1 + i] * T[k * m2 + i];
    for (int64_t i = k; i < nb; ++i) dk += W[i * nb + k] * W[i * nb + k];
    const double br = gc * (xu * xu) + xu * q + s + gl * dk;
    gphi[blk * nb + k] = gl / v - br / (v * v);
  }
}

static int smem_limit(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

extern "C" int kron_pulsar_fwd_launch(
    const double* phi, const double* g_uu, const double* g_uf,
    const double* g_ff, const double* b_u, const double* b_f,
    const double* rr, const double* ld_white, double* chi2, double* x_out,
    double* m_out, double* ld_out, double* L_out, double* X_out,
    int64_t n_blocks, int64_t n_psr, int64_t nb, int64_t m2,
    cudaStream_t stream) {
  const size_t bytes = sizeof(double) * (nb * nb + nb * (1 + m2));
  int err = smem_limit((const void*)kron_pulsar_fwd_kernel, bytes);
  if (err) return err;
  kron_pulsar_fwd_kernel<<<(unsigned)n_blocks, THREADS, bytes, stream>>>(
      phi, g_uu, g_uf, g_ff, b_u, b_f, rr, ld_white, chi2, x_out, m_out,
      ld_out, L_out, X_out, n_psr, nb, m2);
  return (int)cudaGetLastError();
}

extern "C" int kron_pulsar_bwd_launch(
    const double* phi, const double* L, const double* X, const double* gchi,
    const double* gx, const double* gm, const double* gld, double* gphi,
    int64_t n_blocks, int64_t nb, int64_t m2, cudaStream_t stream) {
  const size_t bytes = sizeof(double) * (nb * nb + nb * m2);
  int err = smem_limit((const void*)kron_pulsar_bwd_kernel, bytes);
  if (err) return err;
  kron_pulsar_bwd_kernel<<<(unsigned)n_blocks, THREADS, bytes, stream>>>(
      phi, L, X, gchi, gx, gm, gld, gphi, nb, m2);
  return (int)cudaGetLastError();
}
