"""The port's downhill fitters (``pint_tpu_torch.downhill``) against
pint_tpu's on the CPU.

From the 400-TOA par/tim of tests/test_torch_wls.py with SINI moved from
0.999 to 0.99, where the full first Gauss-Newton step carries SINI past
1 (chi^2 NaN), ``DownhillGLSFitter`` (the par) and ``DownhillWLSFitter``
(the par without ECORR and red noise) both halve the step, and then
must take JAX's path: the same iteration count and ``converged``, the
accepted chi^2 of each iteration within ``tolerances.REFIT_CHI2_REL``,
the fitted values and their uncertainties within the fit rows'
conditioning-aware limits (``tolerances.fit_tolerances``).  On the committed 10k par/tim, the
JAX fits of ``b1855_grid_answers.npz`` (``tools/export_torch_grid_case.py``):
from SINI = 0.995 the same lambdas and all of the above; from SINI =
0.99, whose last step is decided at the noise floor (JAX itself takes
lambda 1, 1/2 or 1/256 there from starts one ulp apart), the iteration
count, ``converged`` and chi^2 per iteration.  Also: a step whose every
trial is invalid leaves the parameters where they were, and
``fit_noise`` is not ported.
"""

import copy
import os

import numpy as np
import pytest
import torch

from bench import B1855_LIKE_PAR
from pint_tpu.downhill import DownhillGLSFitter as JDownhillGLS
from pint_tpu.downhill import DownhillWLSFitter as JDownhillWLS
from pint_tpu.models.builder import get_model_and_toas as jget_mt
from pint_tpu_torch import tolerances as tol
from pint_tpu_torch.convert import (B1855_GRID_ANSWERS, B1855_PAR,
                                    B1855_TIM, B1855_WHITE_PAR, load_arrays)
from pint_tpu_torch.downhill import DownhillGLSFitter, DownhillWLSFitter
from pint_tpu_torch.fitter import GLSFitter, WLSFitter
from pint_tpu_torch.models.builder import get_model, get_model_and_toas
from tests.test_torch_wls import par_tim  # noqa: F401  (fixture)
from tools.export_torch_grid_case import white_par

# one intra-op thread: the tests run at small sizes, and pytest-xdist's
# workers share the machine's cores (torch's default of one thread per
# core in every worker oversubscribes them several times over)
torch.set_num_threads(1)

START = {"SINI": 0.99}
CASES = {"gls": (DownhillGLSFitter, JDownhillGLS, GLSFitter),
         "wls": (DownhillWLSFitter, JDownhillWLS, WLSFitter)}


@pytest.fixture(scope="module")
def pars(par_tim, tmp_path_factory):  # noqa: F811
    """{kind: (par, tim)}: GLS on the par, WLS on its white twin."""
    par, tim = par_tim
    white = tmp_path_factory.mktemp("downhill") / "white.par"
    white.write_text(white_par(B1855_LIKE_PAR))
    return {"gls": (par, tim), "wls": (str(white), tim)}


def _start(par, tim):
    model, toas = get_model_and_toas(par, tim)
    model.values.update(START)
    return model, toas


@pytest.mark.parametrize("kind", ["gls", "wls"])
def test_downhill_matches_jax(pars, kind):
    cls, jcls, plain_cls = CASES[kind]
    par, tim = pars[kind]
    # the plain step from the start is worse (here: invalid), so the
    # halving really runs
    model, toas = _start(par, tim)
    pf = plain_cls(toas, copy.deepcopy(model), device="cpu")
    vec = torch.tensor([model.values[k] for k in pf._traced_free],
                       dtype=torch.float64)
    base = pf.prepared.values_dict()
    dpar = pf._step(vec, base, pf._fit_data)[0]
    before = float(pf.resids.chi2_at(pf._merged(base, vec)))
    after = float(pf.resids.chi2_at(pf._merged(base, vec + dpar)))
    assert not after < before

    jmodel, jtoas = jget_mt(par, tim)
    jmodel.values.update(START)
    os.environ["PINT_TPU_ITER_TRACE"] = "1"
    try:
        jf = jcls(jtoas, jmodel)
        jchi2 = jf.fit_toas()
    finally:
        os.environ.pop("PINT_TPU_ITER_TRACE", None)
    f = cls(toas, model, device="cpu")
    chi2 = f.fit_toas()

    assert f.step_lambdas[0] < 1.0
    assert len(f.chi2_iters) == len(jf.iter_trace)
    assert f.converged == bool(jf.converged)
    cond = f.fit_health["cond_log10"]
    if kind == "wls":
        cond = tol.wls_normal_cond_log10(cond)
    lim = tol.fit_tolerances(cond)
    lim["chi2_rel"] = tol.REFIT_CHI2_REL
    free = list(jmodel.free_params)
    err = tol.fit_errors(
        [model.values[k] for k in free],
        [model.uncertainties[k] for k in free], f.chi2_iters,
        [jmodel.values[k] for k in free],
        [jmodel.params[k].uncertainty for k in free],
        [e["chi2"] for e in jf.iter_trace])
    for k, v in err.items():
        assert v <= lim[k], (k, v, lim[k])
    assert abs(chi2 / jchi2 - 1.0) <= lim["chi2_rel"]


@pytest.fixture(scope="module")
def case_10k():
    """The committed 10k par/tim, its white par and JAX's answers."""
    model, toas = get_model_and_toas(str(B1855_PAR), str(B1855_TIM))
    return ({"gls": model, "wls": get_model(str(B1855_WHITE_PAR))}, toas,
            load_arrays(B1855_GRID_ANSWERS))


@pytest.mark.parametrize("kind", ["gls", "wls"])
@pytest.mark.parametrize("case", ["downhill", "downhill99"])
def test_downhill_10k_matches_jax_file(case_10k, case, kind):
    models, toas, ref = case_10k
    model = copy.deepcopy(models[kind])
    model.values.update({str(k): float(v) for k, v in ref[case + "_start"]})
    f = CASES[kind][0](toas, model, device="cpu")
    chi2 = f.fit_toas()
    p = f"{case}_{kind}_"
    assert len(f.chi2_iters) == int(ref[p + "n_iter"])
    assert f.converged == bool(ref[p + "converged"])
    assert f.step_lambdas[0] < 1.0
    assert np.max(np.abs(np.asarray(f.chi2_iters) / ref[p + "chi2_iters"]
                         - 1)) <= tol.REFIT_CHI2_REL
    assert abs(chi2 / float(ref[p + "final_chi2"]) - 1) \
        <= tol.REFIT_CHI2_REL
    if case == "downhill99":
        return
    assert f.step_lambdas == ref[p + "lambdas"].tolist()
    cond = f.fit_health["cond_log10"]
    if kind == "wls":
        cond = tol.wls_normal_cond_log10(cond)
    lim = tol.fit_tolerances(cond)
    free = [str(k) for k in ref[p + "free_params"]]
    err = tol.fit_errors(
        [model.values[k] for k in free],
        [model.uncertainties[k] for k in free], f.chi2_iters,
        ref[p + "values"], ref[p + "uncertainties"], ref[p + "chi2_iters"])
    assert err["values_sigma"] <= lim["values_sigma"]
    assert err["unc_rel"] <= lim["unc_rel"]


def test_every_trial_invalid_stays_put(pars):
    """No lambda lowers chi^2: the step is not taken, the fit converges
    where it started (the reference keeps its state)."""
    model, toas = _start(*pars["gls"])
    start = dict(model.values)
    f = DownhillGLSFitter(toas, model, device="cpu")
    f.max_halvings = 2
    f._chi2_at = lambda base, vec: float("nan")
    f.fit_toas()
    assert f.step_lambdas == [0.0] and f.converged
    assert len(f.chi2_iters) == 1
    assert all(model.values[k] == start[k] for k in f._traced_free)


def test_fit_noise_is_not_ported(pars):
    model, toas = get_model_and_toas(*pars["gls"])
    f = DownhillGLSFitter(toas, model, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        f.fit_toas(fit_noise=True)
    assert np.isfinite(f.resids.chi2)
