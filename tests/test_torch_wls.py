"""The WLS step and both fitters from par and tim, the port against
pint_tpu on the CPU.

- ``wls_gn_solve``'s plain path (``wls_whiten_plain`` and the SVD) on
  seeded (r, J, err): the step within 1e-12 relative, the same
  ``n_truncated``;
- ``WLSFitter`` and ``GLSFitter`` from a 400-TOA par/tim pair against
  JAX's fits, at the conditioning-aware limits of
  ``pint_tpu_torch.tolerances``;
- a DD fit whose eccentricity crosses a Kepler depth class re-keys to
  the same Newton depth in both packages and lands on JAX's answer
  (the port's twin of tests/test_design.py's postfit-guard test).
"""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import B1855_LIKE_PAR
from pint_tpu.fitter import GLSFitter as JGLSFitter
from pint_tpu.fitter import WLSFitter as JWLSFitter
from pint_tpu.fitter import wls_gn_solve as jwls_gn_solve
from pint_tpu.models.builder import get_model as jget_model
from pint_tpu.models.builder import get_model_and_toas as jget_mt
from pint_tpu.simulation import make_fake_toas_uniform as jfake
from pint_tpu.toa import TOAs as JTOAs
from pint_tpu.toa import write_tim
from pint_tpu_torch import tolerances as tol
from pint_tpu_torch.fitter import GLSFitter, WLSFitter, wls_gn_solve
from pint_tpu_torch.linalg import wls_whiten, wls_whiten_plain
from pint_tpu_torch.models.builder import get_model_and_toas

# one intra-op thread: the tests run at small sizes, and pytest-xdist's
# workers share the machine's cores (torch's default of one thread per
# core in every worker oversubscribes them several times over)
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _system(seed, n=300, p=8, degenerate=False, zero_col=False):
    rng = np.random.default_rng(seed)
    J = rng.standard_normal((n, p)) * 10.0 ** rng.uniform(-6, 6, p)
    if degenerate:  # two columns equal to 1e-16: the cutoff drops one
        J[:, 1] = J[:, 0] * 3.0 * (1.0 + 1e-16 * rng.standard_normal(n))
    if zero_col:
        J[:, -1] = 0.0
    r = rng.standard_normal(n) * 1e-6
    err = rng.uniform(0.5, 2.0, n) * 1e-6
    return r, J, err


@pytest.mark.parametrize("kind", ["plain", "degenerate", "zero_column"])
def test_wls_gn_solve_matches_jax(kind):
    r, J, err = _system(len(kind), degenerate=kind == "degenerate",
                        zero_col=kind == "zero_column")
    vec = np.zeros(J.shape[1])
    _, chi2j, dparj, covj, diagj = jwls_gn_solve(
        None, jnp.asarray(vec), jnp.asarray(err), rj=(jnp.asarray(r),
                                                     jnp.asarray(J)),
        with_health=True)
    dpar, chi2, cov, diag = wls_gn_solve(
        *(torch.tensor(a) for a in (r, J, err)))
    assert int(diag.n_truncated) == int(diagj.n_truncated)
    if kind == "degenerate":
        assert int(diag.n_truncated) == 1
    dparj, covj = np.asarray(dparj), np.asarray(covj)
    assert tol.vector_rel(dpar.numpy(), dparj) <= 1e-12
    assert tol.vector_rel(cov.numpy(), covj) <= 1e-12
    assert abs(float(chi2) / float(chi2j) - 1.0) <= 1e-14
    assert abs(float(diag.cond_log10) - float(diagj.cond_log10)) <= 1e-9


def test_wls_whiten_plain_is_jax_arithmetic():
    """The plain version repeats JAX's lines: rw and the products
    bit-identical, the sums within summation order."""
    r, J, err = _system(11, zero_col=True)
    w = 1.0 / err
    jw = J * w[:, None]
    norms = np.sqrt(np.sum(jw * jw, axis=0))
    norms = np.where(norms == 0, 1.0, norms)
    rw, Jn, nt, chi2 = wls_whiten_plain(
        *(torch.tensor(a) for a in (r, J, err)))
    assert np.array_equal(rw.numpy(), r * w)
    assert tol.vector_rel(nt.numpy(), norms) <= 1e-15
    assert tol.vector_rel(Jn.numpy(), jw / norms) <= 1e-15
    assert abs(float(chi2) / np.sum((r * w) ** 2) - 1) <= 1e-14
    assert float(nt[-1]) == 1.0
    out = wls_whiten(*(torch.tensor(a) for a in (r, J, err)))
    assert all(torch.equal(a, b) for a, b in zip(out, (rw, Jn, nt, chi2)))


def test_wls_whiten_cuda_refuses_cpu_tensors():
    from pint_tpu_torch.linalg import K7, wls_whiten_cuda

    r, J, err = (torch.tensor(a) for a in _system(2, n=10, p=2))
    with pytest.raises(ValueError, match="CUDA"):
        wls_whiten_cuda(r, J, err)
    assert K7.launches == 0


@pytest.fixture(scope="module")
def par_tim(tmp_path_factory):
    """The B1855-like par and a 400-TOA two-band tim (80 epochs of five
    sub-bands), written by pint_tpu."""
    d = tmp_path_factory.mktemp("wls")
    par, tim = d / "b1855.par", d / "b1855.tim"
    par.write_text(B1855_LIKE_PAR)
    model = jget_model(B1855_LIKE_PAR)
    rng = np.random.default_rng(0)
    parts = [jfake(53000.0 + off, 56500.0 + off, 40, model,
                   freq_mhz=np.linspace(lo, hi, 5), obs="gbt",
                   error_us=err, add_noise=True, rng=rng,
                   flags={"f": flag}, multifreq=True)
             for flag, lo, hi, err, off in (
                 ("L-wide", 1150.0, 1750.0, 1.0, 0.0),
                 ("S-wide", 1900.0, 2700.0, 1.5, 0.01))]
    write_tim(JTOAs.merge(parts), str(tim), include_info=False)
    return str(par), str(tim)


def _fitters(jcls, tcls, par, tim):
    """(JAX fitter, the port's fitter), both before their fit; JAX's
    flight recorder is on for its per-iteration chi2."""
    jmodel, jtoas = jget_mt(par, tim)
    model, toas = get_model_and_toas(par, tim)
    os.environ["PINT_TPU_ITER_TRACE"] = "1"
    try:
        jf = jcls(jtoas, copy.deepcopy(jmodel))
    finally:
        os.environ.pop("PINT_TPU_ITER_TRACE", None)
    return jf, tcls(toas, model, device=CPU)


def _fit(jf, tf, maxiter=3):
    """(JAX fitter, its chi2, the port's fitter, its chi2) after both
    fits."""
    os.environ["PINT_TPU_ITER_TRACE"] = "1"
    try:
        jchi2 = jf.fit_toas(maxiter=maxiter)
    finally:
        os.environ.pop("PINT_TPU_ITER_TRACE", None)
    chi2 = tf.fit_toas(maxiter=maxiter)
    return jf, jchi2, tf, chi2


def _fit_both(jcls, tcls, par, tim, maxiter=3):
    """(JAX fitter, its chi2, the port's fitter, its chi2)."""
    return _fit(*_fitters(jcls, tcls, par, tim), maxiter=maxiter)


def _count_calls(obj, name):
    """Wrap ``obj.name`` on the instance; returns the list of calls."""
    calls, inner = [], getattr(obj, name)

    def wrapped(*a, **k):
        calls.append(a)
        return inner(*a, **k)

    setattr(obj, name, wrapped)
    return calls


@pytest.mark.parametrize("which", ["wls", "gls"])
def test_fit_from_par_tim_matches_jax(par_tim, which):
    jcls, tcls = {"wls": (JWLSFitter, WLSFitter),
                  "gls": (JGLSFitter, GLSFitter)}[which]
    jf, jchi2, tf, chi2 = _fit_both(jcls, tcls, *par_tim)
    free = list(jf.model.free_params)
    assert list(tf.model.free_params) == free
    cond = tf.fit_health["cond_log10"]
    if which == "wls":
        cond = tol.wls_normal_cond_log10(cond)
        assert tf.fit_health["n_truncated"] == \
            int(jf.fit_health["n_truncated"])
    lim = tol.fit_tolerances(cond)
    err = tol.fit_errors(
        [tf.model.values[k] for k in free],
        [tf.model.uncertainties[k] for k in free], tf.chi2_iters,
        [jf.model.values[k] for k in free],
        [jf.model.params[k].uncertainty for k in free],
        [e["chi2"] for e in jf.iter_trace])
    for k, v in err.items():
        assert v <= lim[k], (k, v, lim[k])
    assert abs(chi2 / jchi2 - 1.0) <= lim["chi2_rel"]


KEPLER_PAR = (B1855_LIKE_PAR.replace("ECC 0.00002170 1", "ECC 0.049975 1")
              .replace("M2 0.26 1", "M2 0.26")
              .replace("SINI 0.999 1", "SINI 0.999"))


def test_kepler_depth_rekey_matches_jax(tmp_path):
    """TOAs from an orbit with ECC = 0.050025 (Newton depth class 6),
    fitted from a par with ECC = 0.049975 (class 4): the fit crosses the
    class bound at 0.05, both packages deepen the unroll to 6 and refit,
    and the port lands on JAX's answer.  (The step is kept to 5e-5 in
    ECC, 0.46 ms of Roemer delay, well inside the 5.4 ms spin period
    that nearest-pulse residuals can follow.)"""
    true = jget_model(KEPLER_PAR.replace("ECC 0.049975 1",
                                         "ECC 0.050025 1"))
    rng = np.random.default_rng(2)
    toas = jfake(53000.0, 56500.0, 150, true,
                 freq_mhz=np.array([1400.0, 2000.0]), obs="gbt",
                 error_us=1.0, add_noise=True, rng=rng,
                 flags={"f": "L-wide"}, multifreq=True)
    par, tim = tmp_path / "kep.par", tmp_path / "kep.tim"
    par.write_text(KEPLER_PAR)
    write_tim(toas, str(tim), include_info=False)
    from pint_tpu import compile_cache as _cc

    def jdepth():
        return _cc.split_ctx(jf.prepared.ctx)[1]["BinaryDD"]["kepler_iters"]

    jf, tf = _fitters(JWLSFitter, WLSFitter, str(par), str(tim))
    # both start in the par's class and re-key during the fit
    assert jdepth() == 4
    assert tf.prepared.ctx["BinaryDD"]["kepler_iters"] == 4
    assert tf.prepared.tzr_ctx["BinaryDD"]["kepler_iters"] == 4
    jretrace, tretrace = (_count_calls(jf, "_retrace"),
                          _count_calls(tf, "_retrace"))
    jf, jchi2, tf, chi2 = _fit(jf, tf)
    assert len(jretrace) >= 1
    assert len(tretrace) == 1
    assert jdepth() == 6
    assert tf.prepared.ctx["BinaryDD"]["kepler_iters"] == 6
    assert tf.prepared.tzr_ctx["BinaryDD"]["kepler_iters"] == 6
    assert abs(tf.model.values["ECC"] - 0.050025) < 1e-5
    free = list(jf.model.free_params)
    lim = tol.fit_tolerances(tol.wls_normal_cond_log10(
        tf.fit_health["cond_log10"]))
    vs = max(abs(tf.model.values[k] - jf.model.values[k])
             / jf.model.params[k].uncertainty for k in free)
    assert vs <= lim["values_sigma"]
    assert abs(chi2 / jchi2 - 1.0) <= lim["chi2_rel"]
