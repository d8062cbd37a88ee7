"""Parity of pint_tpu_torch.linalg with pint_tpu.linalg.

- The plain version of kernel K2 (fixed-order segment sums) equals
  ``jax.ops.segment_sum`` on the CPU bit for bit: both add each
  segment's rows in ascending order from zero.
- Structured (segment) contractions equal the dense brute force.
- All three ``gls_normal_solve`` branches (gram, structured, dense)
  match pint_tpu on the same inputs at 1e-12 relative on the step and
  chi^2, with equal SolveDiag truncation counts.  The inputs are a
  random, well-conditioned problem (condition number ~1e3), so the
  eigensolvers of the two frameworks agree to a few ulps scaled by it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu import linalg as jl
from pint_tpu_torch import linalg as tl

N, P, K_PRE, K_E, K_POST = 300, 5, 2, 20, 4


def _problem(seed):
    rng = np.random.default_rng(seed)
    # unsorted epoch ids, some rows outside every epoch (id K_E)
    seg = rng.integers(0, K_E + 1, N)
    pre = rng.standard_normal((N, K_PRE))
    post = np.concatenate([rng.standard_normal((N, K_POST - 1)),
                           np.ones((N, 1))], axis=1)
    r = rng.standard_normal(N) * 1e-6
    J = rng.standard_normal((N, P))
    sigma = rng.uniform(0.5, 2.0, N) * 1e-6
    phi = np.concatenate([rng.uniform(0.5, 2.0, K_PRE + K_E + K_POST - 1)
                          * 1e-12, [1e-10]])
    j_su = jl.structured_from_dense_blocks(pre, seg, K_E, post)
    t_su = tl.structured_from_blocks(pre, seg, K_E, post, "cpu")
    return r, J, sigma, phi, j_su, t_su


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("m", [1, 10, 61])
def test_segment_sum_plain_equals_jax_bitwise(m):
    rng = np.random.default_rng(m)
    seg = rng.integers(0, K_E + 1, 1000)
    x = rng.standard_normal((1000, m)) * 1e6
    ref = jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(seg),
                              num_segments=K_E + 1)[:K_E]
    perm, offsets = tl.epoch_csr(seg, K_E)
    got = tl.segment_sum_fixed_order(_t(x), _t(perm), _t(offsets))
    np.testing.assert_array_equal(got.numpy().view(np.int64),
                                  np.asarray(ref).view(np.int64))


def test_segment_sum_vector_and_empty_width():
    seg = np.array([2, 0, 2, 1, 3, 0])
    perm, offsets = tl.epoch_csr(seg, 3)
    assert perm.tolist() == [1, 5, 3, 0, 2]
    x = torch.arange(6, dtype=torch.float64)
    out = tl.segment_sum_fixed_order(x, _t(perm), _t(offsets))
    assert out.tolist() == [6.0, 3.0, 2.0]
    empty = tl.segment_sum_fixed_order(torch.zeros((6, 0),
                                                   dtype=torch.float64),
                                       _t(perm), _t(offsets))
    assert tuple(empty.shape) == (3, 0)


def test_segment_sum_cuda_wrapper_rejects_cpu_tensors():
    perm, offsets = tl.epoch_csr(np.array([0, 1]), 2)
    with pytest.raises(ValueError):
        tl.segment_sum_cuda(torch.zeros((2, 1), dtype=torch.float64),
                            _t(perm), _t(offsets))


def test_structured_equals_dense_bruteforce():
    r, J, sigma, phi, _, su = _problem(0)
    U = tl.su_to_dense(su)
    y = _t(J)
    w = 1.0 / _t(sigma) ** 2
    np.testing.assert_allclose(tl._ut_dot(su, y), U.T @ y, rtol=1e-12,
                               atol=1e-12)
    x = torch.tensor(np.random.default_rng(1).standard_normal(U.shape[1]))
    np.testing.assert_allclose(tl._u_dot(su, x), U @ x, rtol=1e-12,
                               atol=1e-12)
    g = tl._weighted_gram(su, w)
    np.testing.assert_allclose(g, (U.T * w[None, :]) @ U,
                               rtol=1e-12, atol=1e-12 * float(g.max()))
    c_s, l_s = tl.woodbury_chi2_logdet(_t(r), _t(sigma), su, _t(phi))
    c_d, l_d = tl.woodbury_chi2_logdet(_t(r), _t(sigma), U, _t(phi))
    assert abs(float(c_s) / float(c_d) - 1) < 1e-12
    assert abs(float(l_s) / float(l_d) - 1) < 1e-12
    # the Woodbury chi^2 equals the dense r^T C^-1 r
    C = torch.diag(_t(sigma) ** 2) + U @ torch.diag(_t(phi)) @ U.T
    assert abs(float(c_d) / float(_t(r) @ torch.linalg.solve(C, _t(r)))
               - 1) < 1e-9


@pytest.mark.parametrize("branch", ["gram", "structured", "dense"])
def test_gls_normal_solve_matches_jax(branch):
    r, J, sigma, phi, j_su, t_su = _problem(2)
    if branch == "dense":
        j_U, t_U = jl.su_to_dense(j_su), tl.su_to_dense(t_su)
    else:
        j_U, t_U = j_su, t_su
    j_gram = t_gram = None
    if branch == "gram":
        j_gram = jl.noise_gram_precompute(jnp.asarray(sigma), j_U,
                                          jnp.asarray(phi))
        t_gram = tl.noise_gram_precompute(_t(sigma), t_U, _t(phi))
        np.testing.assert_allclose(t_gram.numpy(), np.asarray(j_gram),
                                   rtol=1e-13, atol=0)
    jd, jc, jn, jchi2, jdiag = jl.gls_normal_solve(
        jnp.asarray(r), jnp.asarray(J), jnp.asarray(sigma), j_U,
        jnp.asarray(phi), gram=j_gram, with_health=True)
    td, tc, tn, tchi2, tdiag = tl.gls_normal_solve(
        _t(r), _t(J), _t(sigma), t_U, _t(phi), gram=t_gram,
        with_health=True)
    jd = np.asarray(jd)
    assert np.max(np.abs(td.numpy() - jd)) <= 1e-12 * np.max(np.abs(jd))
    assert abs(float(tchi2) / float(jchi2) - 1) <= 1e-12
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-10,
                               atol=1e-12 * np.max(np.abs(np.asarray(jc))))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-9,
                               atol=1e-12 * np.max(np.abs(np.asarray(jn))))
    assert int(tdiag.n_truncated) == int(jdiag.n_truncated)
    assert abs(float(tdiag.cond_log10) - float(jdiag.cond_log10)) < 1e-9


def test_failed_cholesky_gives_nan_like_jax():
    """cho_factor returns NaN on a failed factorization (JAX semantics)
    instead of raising, and the NaN reaches the gram-branch chi^2."""
    A = np.array([[1.0, 2.0], [2.0, 1.0]])
    jL = jax.scipy.linalg.cho_factor(jnp.asarray(A), lower=True)[0]
    tL = tl.cho_factor(_t(A))
    assert np.isnan(np.asarray(jL)).any() and torch.isnan(tL).all()
    r, J, sigma, phi, j_su, t_su = _problem(3)
    k = tl.basis_ncols(t_su)
    bad = -np.eye(k)
    jchi2 = jl.gls_normal_solve(jnp.asarray(r), jnp.asarray(J),
                                jnp.asarray(sigma), j_su, jnp.asarray(phi),
                                gram=jnp.asarray(bad))[3]
    tchi2 = tl.gls_normal_solve(_t(r), _t(J), _t(sigma), t_su, _t(phi),
                                gram=_t(bad))[3]
    assert np.isnan(float(jchi2)) and np.isnan(float(tchi2))
