"""Parity of pint_tpu_torch.fixedpoint with pint_tpu.fixedpoint.

The plain PyTorch version of kernel K1 must reproduce the JAX
fixed-point phase bit for bit — integer turns and the float64 fraction —
including the NaN-poison branch and the renorm floor rule; its jvp
tangent is t * dF0.  The CUDA kernel itself is held to this plain
version by chip_smoke.py on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu import fixedpoint as jfp
from pint_tpu_torch import fixedpoint as tfp


def _cases(seed, n=4000):
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(1.0, 2048.0, n)
    tmax = np.minimum(2.0**62, 0.999 * 2.0**43 / f0 * 2.0**32)
    ticks = np.round(rng.uniform(-1.0, 1.0, n) * tmax).astype(np.int64)
    return f0, ticks


def _bits(x):
    return np.asarray(x, dtype=np.float64).view(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_phase_f0_t_bit_identical(seed):
    f0, ticks = _cases(seed)
    for i in range(0, len(f0), 500):  # a scalar F0 per call, as the fit
        jn, jf = jfp.phase_f0_t(jnp.float64(f0[i]), jnp.asarray(ticks))
        tn, tf = tfp.phase_f0_t(torch.tensor(f0[i]), torch.tensor(ticks))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(_bits(tf.numpy()), _bits(jf))


def test_phase_f0_t_per_toa_f0_matches_scalar_calls():
    f0, ticks = _cases(3, n=64)
    tn, tf = tfp.phase_f0_t_plain(torch.tensor(f0), torch.tensor(ticks))
    for i in range(len(f0)):
        jn, jf = jfp.phase_f0_t(jnp.float64(f0[i]), jnp.asarray(ticks[i]))
        assert int(tn[i]) == int(jn)
        assert _bits(float(tf[i])) == _bits(float(jf))


@pytest.mark.parametrize("f0,tick", [
    (0.0, 2**40), (-1.0, 2**40), (2048.0, 2**40), (4096.0, 2**40),
    (np.nan, 2**40), (np.inf, 2**40), (-np.inf, 2**40),
    (1.0, 1 << 62), (1.0, -(1 << 62)), (2047.0, (1 << 63) - 1),
    (1e-300, 5), (np.nextafter(2048.0, 0.0), 2**40),
])
def test_poison_and_edges(f0, tick):
    t = np.array([tick, 12345, -(2**35)], dtype=np.int64)
    jn, jf = jfp.phase_f0_t(jnp.float64(f0), jnp.asarray(t))
    tn, tf = tfp.phase_f0_t(torch.tensor(f0, dtype=torch.float64),
                            torch.tensor(t))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(_bits(tf.numpy()), _bits(jf))


def test_mul_64x64_128_matches_python_ints():
    rng = np.random.default_rng(5)
    a = rng.integers(-(2**63), 2**63 - 1, 2000, dtype=np.int64)
    b = rng.integers(-(2**63), 2**63 - 1, 2000, dtype=np.int64)
    hi, lo = tfp.mul_64x64_128(torch.tensor(a), torch.tensor(b))
    for i in range(0, 2000, 37):
        p = int(a[i]) * int(b[i])
        assert int(hi[i]) == p >> 64
        assert int(lo[i]) & (2**64 - 1) == p & (2**64 - 1)


@pytest.mark.parametrize("frac", [0.5, -0.5, 0.49999999999999994, 1.5,
                                  -1.5, 2.25, -0.75, 0.0])
def test_renorm_phase_floor_rule(frac):
    n = np.array([7, -7], dtype=np.int64)
    fr = np.array([frac, -frac])
    jn, jf = jfp.renorm_phase(jnp.asarray(n), jnp.asarray(fr))
    tn, tf = tfp.renorm_phase(torch.tensor(n), torch.tensor(fr))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(_bits(tf.numpy()), _bits(jf))


def test_jvp_tangent_is_t_dF0():
    _, ticks = _cases(6, n=100)
    ticks = ticks // 1024
    t = torch.tensor(ticks)
    f0 = torch.tensor(186.49408156698235, dtype=torch.float64)
    df0 = torch.tensor(1.0, dtype=torch.float64)
    (n, frac), (_, dfrac) = torch.func.jvp(
        lambda f: tfp.phase_f0_t(f, t), (f0,), (df0,))
    np.testing.assert_array_equal(
        dfrac.numpy(), tfp.ticks_to_seconds(t).numpy())
    # and under jacfwd, as the fitter uses it
    jac = torch.func.jacfwd(lambda f: tfp.phase_f0_t(f, t)[1])(f0)
    np.testing.assert_array_equal(jac.numpy(),
                                  tfp.ticks_to_seconds(t).numpy())


def test_cuda_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError):
        tfp.phase_f0_t_cuda(torch.tensor(1.0, dtype=torch.float64),
                            torch.zeros(3, dtype=torch.int64))
