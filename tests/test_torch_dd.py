"""The port's double-double arithmetic (``pint_tpu_torch.dd``) against
pint_tpu.dd bit for bit, and against the host numpy.longdouble oracle
as tests/test_dd.py holds pint_tpu.dd.

Inputs are numpy arrays from fixed seeds, handed to both packages on
the CPU; every output of every function must have the same bits (the
same chain of separately rounded IEEE operations).  The card's twin,
bit identity of CUDA tensors with these CPU calls, is
tests/test_torch_cuda.py's and chip_smoke.py's ``dd`` phase.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu import dd as jdd
from pint_tpu_torch import dd

# one intra-op thread: the tests run at small sizes, and pytest-xdist's
# workers share the machine's cores (torch's default of one thread per
# core in every worker oversubscribes them several times over)
torch.set_num_threads(1)

N = 2000


def rand_ld(rng, n, scale=1e9):
    """Random longdoubles with nontrivial low bits."""
    a = rng.uniform(-1, 1, n).astype(np.longdouble) * np.longdouble(scale)
    b = rng.uniform(-1, 1, n).astype(np.longdouble)
    return a + b * np.longdouble(2.0) ** -40


def _inputs(seed):
    """(x, y) as exact dd pairs of seeded longdoubles at mixed scales,
    plus half-integer and integer edge cases in x."""
    rng = np.random.default_rng(seed)
    x = rand_ld(rng, N, 4e11)
    y = rand_ld(rng, N, 1e3)
    x[:6] = [123456789.5, -0.5, 0.5, 7.0, -3.0, 2.0**52]
    x[6:9] = np.longdouble(123456789.5) + np.longdouble(2.0) ** -45 * \
        np.asarray([-1, 0, 1], dtype=np.longdouble)
    return x, y


def _pair(x):
    hi = x.astype(np.float64)
    lo = (x - hi.astype(np.longdouble)).astype(np.float64)
    return hi, lo


def _bits(a):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    if a.dtype == np.bool_:
        return a
    return np.ascontiguousarray(a, dtype=np.float64).view(np.int64)


def _same(got, ref):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _same(g, r)
        return
    assert np.array_equal(_bits(got), _bits(ref))


def _both(seed):
    x, y = _inputs(seed)
    (xh, xl), (yh, yl) = _pair(x), _pair(y)
    tx = dd.DD(torch.tensor(xh), torch.tensor(xl))
    ty = dd.DD(torch.tensor(yh), torch.tensor(yl))
    jx = jdd.DD(jnp.asarray(xh), jnp.asarray(xl))
    jy = jdd.DD(jnp.asarray(yh), jnp.asarray(yl))
    return (tx, ty), (jx, jy)


#: (name, call with the module and the two dd inputs)
CASES = [
    ("two_sum", lambda m, x, y: m.two_sum(x.hi, y.hi)),
    ("two_sum_lo", lambda m, x, y: m.two_sum(x.lo, y.hi)),
    ("quick_two_sum", lambda m, x, y: m.quick_two_sum(x.hi, y.hi)),
    ("split", lambda m, x, y: m.split(x.hi)),
    ("two_prod", lambda m, x, y: m.two_prod(x.hi, y.hi)),
    ("two_prod_lo", lambda m, x, y: m.two_prod(x.lo, y.hi)),
    ("from_f64", lambda m, x, y: m.from_f64(x.hi)),
    ("from_sum", lambda m, x, y: m.from_sum(x.hi, y.lo)),
    ("normalize", lambda m, x, y: m.normalize(x.hi, y.hi)),
    ("to_f64", lambda m, x, y: m.to_f64(x)),
    ("add", lambda m, x, y: m.add(x, y)),
    ("add_f64", lambda m, x, y: m.add_f64(x, y.hi)),
    ("sub", lambda m, x, y: m.sub(x, y)),
    ("sub_f64", lambda m, x, y: m.sub_f64(x, y.hi)),
    ("mul", lambda m, x, y: m.mul(x, y)),
    ("mul_f64", lambda m, x, y: m.mul_f64(x, y.hi)),
    ("div", lambda m, x, y: m.div(x, y)),
    ("neg", lambda m, x, y: m.neg(x)),
    ("abs_", lambda m, x, y: m.abs_(x)),
    ("sqr", lambda m, x, y: m.sqr(y)),
    ("lt", lambda m, x, y: m.lt(x, y)),
    ("le", lambda m, x, y: m.le(x, x)),
    ("gt", lambda m, x, y: m.gt(x, y)),
    ("ge", lambda m, x, y: m.ge(y, x)),
    ("round_nearest", lambda m, x, y: m.round_nearest(x)),
    ("split_int_frac", lambda m, x, y: m.split_int_frac(x)),
    ("floor_", lambda m, x, y: m.floor_(x)),
    ("horner", lambda m, x, y: m.horner(m.mul_f64(y, 1e-3),
                                        [x, y, m.from_f64(0.25 * y.hi)])),
    ("taylor_horner", lambda m, x, y: m.taylor_horner(
        m.mul_f64(y, 1e3), [m.from_f64(0.0 * y.hi), m.from_f64(218.81184
                                                               + 0 * y.hi),
                            m.from_f64(-4.083e-16 + 0 * y.hi),
                            m.from_f64(1e-26 + 0 * y.hi)])),
    ("operators", lambda m, x, y: ((x + y) * y - x / y, 2.0 - x, -x)),
]


@pytest.mark.parametrize("name,fn", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("seed", [0, 1])
def test_bit_identical_to_pint_tpu(name, fn, seed):
    (tx, ty), (jx, jy) = _both(seed)
    _same(fn(dd, tx, ty), fn(jdd, jx, jy))


def test_from_to_longdouble_roundtrip():
    x = rand_ld(np.random.default_rng(42), 1000)
    d = dd.from_longdouble(x)
    assert np.all(dd.to_longdouble(d) == x)
    # canonical: |lo| <= ulp(hi)/2
    assert np.all(np.abs(d.lo.numpy()) <= np.spacing(np.abs(d.hi.numpy())))
    _same(tuple(d), tuple(jdd.from_longdouble(x)))


@pytest.mark.parametrize("op,ldop", [
    (dd.add, np.add), (dd.sub, np.subtract), (dd.mul, np.multiply),
    (dd.div, np.divide)])
def test_binary_ops_match_longdouble(op, ldop):
    rng = np.random.default_rng(7)
    x, y = rand_ld(rng, 2000), rand_ld(rng, 2000)
    res = dd.to_longdouble(op(dd.from_longdouble(x), dd.from_longdouble(y)))
    expect = ldop(x, y)
    # dd has ~1e-32 relative error, longdouble ~5e-20: the oracle limits
    assert np.max(np.abs((res - expect) / expect)) < np.longdouble(1e-18)


def test_add_exactness_catastrophic_cancellation():
    big, tiny = dd.from_f64(4e11), dd.from_f64(1e-7)
    assert float(dd.to_f64(dd.sub(dd.add(big, tiny), big))) == 1e-7


def test_two_prod_exact():
    rng = np.random.default_rng(3)
    a, b = rng.uniform(-1e8, 1e8, 500), rng.uniform(-1e8, 1e8, 500)
    p, e = dd.two_prod(torch.tensor(a), torch.tensor(b))
    expect = a.astype(np.longdouble) * b.astype(np.longdouble)
    got = p.numpy().astype(np.longdouble) + e.numpy().astype(np.longdouble)
    assert np.all(got == expect)


def test_mul_precision_phase_scale():
    f0 = np.longdouble("61.485476554")
    t = np.longdouble("567890123.4567890123")
    got = dd.to_longdouble(dd.mul(dd.from_longdouble(f0),
                                  dd.from_longdouble(t)))
    assert abs(got - f0 * t) / (f0 * t) < np.longdouble(1e-18)


def test_split_int_frac_invariant():
    x = rand_ld(np.random.default_rng(5), 3000, scale=4e11)
    n, frac = dd.split_int_frac(dd.from_longdouble(x))
    f = frac.hi.numpy()
    assert np.all(f >= -0.5) and np.all(f < 0.5)
    recon = n.numpy().astype(np.longdouble) + dd.to_longdouble(frac)
    assert np.max(np.abs(recon - x)) < np.longdouble(1e-18) * np.max(
        np.abs(x))


def test_split_int_frac_near_half():
    base, eps = np.longdouble(123456789.5), np.longdouble(2.0) ** -45
    for x in (base - eps, base, base + eps):
        _, frac = dd.split_int_frac(dd.from_longdouble(x))
        assert -0.5 <= float(frac.hi) < 0.5, x


def test_floor():
    xs = np.array([1.9999999, -1.0000001, 5.0, -3.0, 0.49, -0.49])
    assert np.array_equal(dd.floor_(dd.from_f64(torch.tensor(xs))).numpy(),
                          np.floor(xs))
    # hi lands exactly on an integer but lo is negative
    x = dd.DD(torch.tensor(7.0, dtype=torch.float64),
              torch.tensor(-1e-20, dtype=torch.float64))
    assert float(dd.floor_(x)) == 6.0


def test_horner_vs_longdouble():
    t = np.longdouble("3.1557e8")
    f0, f1, f2 = (np.longdouble("218.81184"), np.longdouble("-4.083e-16"),
                  np.longdouble("1e-26"))
    expect = t * (f0 + t * (f1 / 2 + t * f2 / 6))
    got = dd.taylor_horner(dd.from_longdouble(t), [
        dd.from_f64(0.0), dd.from_longdouble(f0), dd.from_longdouble(f1),
        dd.from_longdouble(f2)])
    assert abs(dd.to_longdouble(got) - expect) / expect \
        < np.longdouble(5e-18)


def test_comparisons():
    a, b = dd.from_sum(1.0, 1e-20), dd.from_f64(1.0)
    assert bool(dd.gt(a, b)) and bool(dd.le(b, a))
    assert not bool(dd.lt(a, b))


def test_div_by_small():
    phase = dd.from_sum(0.25, 3e-18)
    t = dd.to_longdouble(dd.div(phase, dd.from_f64(641.92822466)))
    expect = (np.longdouble(0.25) + np.longdouble(3e-18)) \
        / np.longdouble(641.92822466)
    assert abs(t - expect) / expect < np.longdouble(1e-18)
