"""The fitters' guard on a non-finite step (``pint_tpu_torch.fitter.
guarded``), the port against pint_tpu on the CPU.

torch's SVD and eigh raise ``LinAlgError`` on a non-finite matrix, where
the reference's solve returns NaN and its fit raises
``FitDivergedError``.  With the guard:

- ``wls_gn_solve`` and ``gls_normal_solve`` on a design with a NaN
  return NaN instead of raising, and on finite inputs give the
  unguarded solve's bits;
- ``WLSFitter`` and ``GLSFitter`` from a start whose SINI is NaN (every
  DD Shapiro delay NaN) raise ``FitDivergedError``, as JAX's fitters do
  on the same par and tim, and leave the model's values alone;
- a downhill fitter whose proposed step is NaN counts every trial as
  worse and stays put (lambda 0) instead of raising ``LinAlgError``;
- a finite fit is the unguarded fit, bit for bit.
"""

import copy

import numpy as np
import pytest
import torch

from pint_tpu.fitter import GLSFitter as JGLSFitter
from pint_tpu.fitter import WLSFitter as JWLSFitter
from pint_tpu.guard import FitDivergedError as JFitDivergedError
from pint_tpu.models.builder import get_model_and_toas as jget_mt
from pint_tpu_torch import fitter as tf
from pint_tpu_torch.downhill import DownhillWLSFitter
from pint_tpu_torch.fitter import (FitDivergedError, GLSFitter, WLSFitter,
                                   guarded, wls_gn_solve)
from pint_tpu_torch.linalg import gls_normal_solve
from pint_tpu_torch.models.builder import get_model_and_toas
from tests.test_torch_wls import par_tim  # noqa: F401  (fixture)

# one intra-op thread: the tests run at small sizes, and pytest-xdist's
# workers share the machine's cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
KINDS = {"wls": (JWLSFitter, WLSFitter), "gls": (JGLSFitter, GLSFitter)}


def _system(seed, n=200, p=6, nb=5):
    rng = np.random.default_rng(seed)
    J = rng.standard_normal((n, p)) * 10.0 ** rng.uniform(-4, 4, p)
    r = rng.standard_normal(n) * 1e-6
    err = rng.uniform(0.5, 2.0, n) * 1e-6
    U = rng.standard_normal((n, nb))
    phi = 10.0 ** rng.uniform(-14, -12, nb)
    return tuple(torch.tensor(a) for a in (r, J, err, U, phi))


def _bits_equal(a, b):
    a, b = np.atleast_1d(a), np.atleast_1d(b)
    return a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("kind", ["wls", "gls"])
def test_guarded_solve_nan_not_raise(kind):
    r, J, err, U, phi = _system(3)
    J[7, 2] = float("nan")
    if kind == "wls":
        with pytest.raises(torch.linalg.LinAlgError):
            wls_gn_solve(r, J, err)
        out = guarded(wls_gn_solve, r, J, err)
    else:
        out = guarded(gls_normal_solve, r, J, err, U, phi, with_health=True)
    tensors = [o for o in out if isinstance(o, torch.Tensor)]
    assert tensors and all(torch.isnan(o).all() for o in tensors)


@pytest.mark.parametrize("kind", ["wls", "gls", "gls_gram"])
def test_guarded_solve_finite_bit_for_bit(kind):
    r, J, err, U, phi = _system(4)
    if kind == "wls":
        want = wls_gn_solve(r, J, err)
        got = guarded(wls_gn_solve, r, J, err)
    else:
        kw = {"with_health": True}
        if kind == "gls_gram":
            from pint_tpu_torch.linalg import noise_gram_precompute
            kw["gram"] = noise_gram_precompute(err, U, phi)
        want = gls_normal_solve(r, J, err, U, phi, **kw)
        got = guarded(gls_normal_solve, r, J, err, U, phi, **kw)
    flat = [(a, b) for a, b in zip(want, got)]
    for a, b in flat:
        if isinstance(a, torch.Tensor):
            assert _bits_equal(a.numpy(), b.numpy())
        else:  # SolveDiag
            assert all(_bits_equal(x.numpy(), y.numpy())
                       for x, y in zip(a, b))


@pytest.mark.parametrize("kind", ["wls", "gls"])
def test_nan_start_raises_fit_diverged_as_jax(par_tim, kind):  # noqa: F811
    jcls, tcls = KINDS[kind]
    jmodel, jtoas = jget_mt(*par_tim)
    jmodel.values["SINI"] = float("nan")
    with pytest.raises(JFitDivergedError):
        jcls(jtoas, jmodel).fit_toas(maxiter=2)
    model, toas = get_model_and_toas(*par_tim)
    model.values["SINI"] = float("nan")
    start = dict(model.values)
    with pytest.raises(FitDivergedError) as e:
        tcls(toas, model, device=CPU).fit_toas(maxiter=2)
    assert not isinstance(e.value, torch.linalg.LinAlgError)
    keys = sorted(start)
    assert sorted(model.values) == keys
    assert _bits_equal(np.array([model.values[k] for k in keys], float),
                       np.array([start[k] for k in keys], float))


def test_downhill_nan_step_stays_put(par_tim, monkeypatch):  # noqa: F811
    """A NaN design column makes the proposed step NaN: every trial is
    worse, the fitter takes lambda 0, and the NaN covariance raises
    FitDivergedError (not LinAlgError) before any value is written."""
    model, toas = get_model_and_toas(*par_tim)
    f = DownhillWLSFitter(toas, model, device=CPU)
    inner = f._rj

    def nan_design(*a, **k):
        r, J = inner(*a, **k)
        J = J.clone()
        J[0, 0] = float("nan")
        return r, J

    monkeypatch.setattr(f, "_rj", nan_design)
    start = dict(model.values)
    with pytest.raises(FitDivergedError):
        f.fit_toas(maxiter=3)
    assert f.step_lambdas == [0.0]
    keys = sorted(start)
    assert _bits_equal(np.array([model.values[k] for k in keys], float),
                       np.array([start[k] for k in keys], float))


@pytest.mark.parametrize("kind", ["wls", "gls"])
def test_finite_fit_unchanged_by_guard(par_tim, monkeypatch, kind):  # noqa: F811
    """The guarded fit and a fit with the guard taken out give the same
    bits: values, uncertainties and chi^2 per iteration."""
    _, tcls = KINDS[kind]
    outs = []
    for strip in (False, True):
        if strip:
            monkeypatch.setattr(tf, "guarded",
                                lambda solve, *a, **k: solve(*a, **k))
        model, toas = get_model_and_toas(*par_tim)
        m = copy.deepcopy(model)
        f = tcls(toas, m, device=CPU)
        f.fit_toas(maxiter=2)
        free = list(m.free_params)
        outs.append((np.array([m.values[k] for k in free]),
                     np.array([m.uncertainties[k] for k in free]),
                     np.array(f.chi2_iters)))
    for a, b in zip(*outs):
        assert _bits_equal(a, b)
