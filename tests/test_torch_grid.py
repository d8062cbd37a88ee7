"""The port's chi^2 grids (``pint_tpu_torch.grid``), the Woodbury
precompute and kernel K8's plain version, and the batching rules of
kernels K1, K2, K7 and K8, against pint_tpu on the CPU.

- ``woodbury_precompute`` / ``woodbury_chi2_logdet_pre`` against JAX's
  for one residual vector and for a stack of them, over a structured
  basis with rows outside every epoch and over a dense one: chi^2
  within ``tolerances.WOODBURY_PRE_REL`` of sum r^2/n, logdet 1e-13;
  the port's GLS step with a gram, and its chi^2 from the precompute,
  against JAX's ``gls_normal_solve(pre=, gram=)``;
- each batching rule under ``torch.func.vmap``: the plain version runs
  once per batched call (a spy counts it), and the result equals a loop
  over points bit for bit (K1, K2, K7; K8 equals its own stacked call);
- 3 x 3 grids from the 400-TOA par/tim of tests/test_torch_wls.py:
  GLS over (M2, SINI) and WLS over (F0, F1) on the par without its
  correlated noise, against ``pint_tpu.grid``: chi^2 within
  ``tolerances.REFIT_CHI2_REL``, the refit values within the fit rows'
  conditioning-aware limits (``tolerances.fit_tolerances`` of the
  refit's normal matrix, less one ulp, ``tolerances.values_sigma_ulp``);
  ``chunk=`` equal to unchunked at the same limits; the tuple and
  derived variants;
- the entry points raise with no CUDA device unless given
  ``device="cpu"``.
"""

import copy
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import B1855_LIKE_PAR
from pint_tpu import grid as jgrid
from pint_tpu import linalg as jl
from pint_tpu.models.builder import get_model_and_toas as jget_mt
from pint_tpu_torch import fixedpoint as tfp
from pint_tpu_torch import grid as tgrid
from pint_tpu_torch import linalg as tl
from pint_tpu_torch import tolerances as tol
from pint_tpu_torch.fitter import GLSFitter, WLSFitter
from pint_tpu_torch.models.builder import get_model_and_toas
from pint_tpu_torch.residuals import Residuals
from tests.test_torch_wls import par_tim  # noqa: F401  (fixture)
from tools.export_torch_grid_case import white_par

# one intra-op thread: the tests run at small sizes, and pytest-xdist's
# workers share the machine's cores (torch's default of one thread per
# core in every worker oversubscribes them several times over)
torch.set_num_threads(1)

N, K_PRE, K_E, K_POST = 300, 7, 20, 2


def _t(a):
    return torch.tensor(np.asarray(a))


def _basis(seed, g=5):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, K_E + 1, N)  # id K_E: outside every epoch
    pre = rng.standard_normal((N, K_PRE))
    post = np.concatenate([rng.standard_normal((N, K_POST - 1)),
                           np.ones((N, 1))], axis=1)
    sigma = rng.uniform(0.5, 2.0, N) * 1e-6
    phi = np.concatenate([rng.uniform(0.5, 2.0, K_PRE + K_E + K_POST - 1)
                          * 1e-12, [1e30]])
    R = rng.standard_normal((g, N)) * 1e-6 + 2e-6
    return seg, pre, post, sigma, phi, R


@pytest.mark.parametrize("g", [5, 16, 37])
@pytest.mark.parametrize("basis", ["structured", "dense"])
def test_woodbury_pre_matches_jax(basis, g):
    """K8's plain version against the reference at 5 points, the GLS
    chain's 16 and 37 (a multiple of neither of K8's point tiles)."""
    seg, pre, post, sigma, phi, R = _basis(1, g)
    j_su = jl.structured_from_dense_blocks(pre, seg, K_E, post)
    t_su = tl.structured_from_blocks(pre, seg, K_E, post, "cpu")
    if basis == "dense":
        j_su, t_su = jl.su_to_dense(j_su), tl.su_to_dense(t_su)
    jp = jl.woodbury_precompute(jnp.asarray(sigma), j_su, jnp.asarray(phi))
    tp = tl.woodbury_precompute(_t(sigma), t_su, _t(phi))
    assert abs(float(tp.logdet) / float(jp.logdet) - 1) <= 1e-13
    jc = np.array([float(jl.woodbury_chi2_logdet_pre(jnp.asarray(r), jp)[0])
                   for r in R])
    scale = np.sum(R**2 / sigma**2, axis=1)
    one = np.array([float(tl.woodbury_chi2_logdet_pre(_t(r), tp)[0])
                    for r in R])
    stacked, logdet = tl.woodbury_chi2_logdet_pre(_t(R), tp)
    assert stacked.shape == (g,) and logdet is tp.logdet
    for got in (one, stacked.numpy()):
        assert np.max(np.abs(got - jc) / scale) <= tol.WOODBURY_PRE_REL
    # the plain version is the reference's formula: its own factor
    x = tl.cho_solve(tp.chol_lower, tl._ut_dot(t_su, _t(R[0] / sigma**2)))
    assert torch.equal(tp.chol_upper, tp.chol_lower.T.contiguous())
    assert abs(float(_t(R[0] / sigma**2) @ _t(R[0]))
               - float(tl._ut_dot(t_su, _t(R[0] / sigma**2)) @ x)
               - one[0]) <= 1e-13 * scale[0]


def test_gls_normal_solve_with_pre_matches_jax():
    seg, pre, post, sigma, phi, R = _basis(2)
    rng = np.random.default_rng(3)
    J = rng.standard_normal((N, 4))
    j_su = jl.structured_from_dense_blocks(pre, seg, K_E, post)
    t_su = tl.structured_from_blocks(pre, seg, K_E, post, "cpu")
    jp = jl.woodbury_precompute(jnp.asarray(sigma), j_su, jnp.asarray(phi))
    tp = tl.woodbury_precompute(_t(sigma), t_su, _t(phi))
    jg = jl.noise_gram_precompute(jnp.asarray(sigma), j_su, jnp.asarray(phi))
    tg = tl.noise_gram_precompute(_t(sigma), t_su, _t(phi))
    jd, _, _, jchi2 = jl.gls_normal_solve(
        jnp.asarray(R[0]), jnp.asarray(J), jnp.asarray(sigma), j_su,
        jnp.asarray(phi), pre=jp, gram=jg)
    # the port's grid takes the step with the gram alone and the chi^2
    # from the precompute (kernel K8 on CUDA), once per point
    td, _, _, tchi2 = tl.gls_normal_solve(_t(R[0]), _t(J), _t(sigma), t_su,
                                          _t(phi), gram=tg)
    jd = np.asarray(jd)
    assert np.max(np.abs(td.numpy() - jd)) <= 1e-12 * np.max(np.abs(jd))
    scale = np.sum(R[0]**2 / sigma**2)
    pre_chi2 = float(tl.woodbury_chi2_logdet_pre(_t(R[0]), tp)[0])
    for got in (float(tchi2), pre_chi2):
        assert abs(got - float(jchi2)) <= tol.WOODBURY_PRE_REL * scale


def _spy(monkeypatch, module, name):
    calls, inner = [], getattr(module, name)

    def wrapped(*a):
        calls.append(tuple(x.shape for x in a))
        return inner(*a)

    monkeypatch.setattr(module, name, wrapped)
    return calls, inner


def _bits(a, b):
    return torch.equal(a.contiguous().view(torch.int64),
                       b.contiguous().view(torch.int64))


def test_k1_batching_rule(monkeypatch):
    """A batch of F0 values against one tick array: one call of the
    plain version, bit-identical to a loop; jacfwd composes under it."""
    rng = np.random.default_rng(4)
    t = _t(rng.integers(-2**50, 2**50, 40))
    f0 = _t(186.49408156698235 + rng.normal(0, 1e-9, 6))
    calls, plain = _spy(monkeypatch, tfp, "phase_f0_t_plain")
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        n, frac = torch.func.vmap(lambda f: tfp.phase_f0_t(f, t))(f0)
        assert calls == [((6, 1), (40,))]
        jac = torch.func.vmap(torch.func.jacfwd(
            lambda f: tfp.phase_f0_t(f, t)[1]))(f0)
    assert len(calls) == 2
    for i in range(6):
        ni, fi = plain(f0[i], t)
        assert torch.equal(n[i], ni) and _bits(frac[i], fi)
        assert torch.equal(jac[i], tfp.ticks_to_seconds(t))


def test_k2_batching_rule(monkeypatch):
    """A batched right-hand side folds into the columns: one call."""
    seg, *_ = _basis(5)
    perm, offsets = (_t(a) for a in tl.epoch_csr(seg, K_E))
    x = _t(np.random.default_rng(5).standard_normal((4, N, 3)) * 1e6)
    calls, plain = _spy(monkeypatch, tl, "segment_sum_plain")
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        out = torch.func.vmap(
            lambda y: tl.segment_sum_fixed_order(y, perm, offsets))(x)
    assert calls == [((N, 12), (perm.numel(),), (K_E + 1,))]
    for i in range(4):
        assert _bits(out[i], plain(x[i], perm, offsets))
    with pytest.raises(NotImplementedError, match="batched structure"):
        torch.func.vmap(lambda p: tl.segment_sum_fixed_order(
            x[0], p, offsets))(perm[None].expand(2, -1))


def test_k7_batching_rule(monkeypatch):
    """(G, N) residuals and (G, N, P) designs against one err: one
    call; a stacked err too."""
    rng = np.random.default_rng(6)
    r = _t(rng.standard_normal((5, 400)) * 1e-6)
    J = _t(rng.standard_normal((5, 400, 8)) * 10.0 ** rng.uniform(-8, 8, 8))
    err = _t(rng.uniform(0.5, 2.0, 400) * 1e-6)
    errs = _t(rng.uniform(0.5, 2.0, (5, 400)) * 1e-6)
    calls, plain = _spy(monkeypatch, tl, "wls_whiten_plain")
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        shared = torch.func.vmap(lambda a, b: tl.wls_whiten(a, b, err))(r, J)
        own = torch.func.vmap(tl.wls_whiten)(r, J, errs)
    assert [c[2] for c in calls] == [(400,), (5, 400)]
    for g in range(5):
        for out, e in ((shared, err), (own, errs[g])):
            assert all(_bits(a[g], b)
                       for a, b in zip(out, plain(r[g], J[g], e)))


def test_k8_batching_rule(monkeypatch):
    seg, pre, post, sigma, phi, R = _basis(7)
    tp = tl.woodbury_precompute(
        _t(sigma), tl.structured_from_blocks(pre, seg, K_E, post, "cpu"),
        _t(phi))
    calls, _ = _spy(monkeypatch, tl, "woodbury_chi2_pre_plain")
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        out = torch.func.vmap(
            lambda r: tl.woodbury_chi2_logdet_pre(r, tp)[0])(_t(R))
    assert len(calls) == 1 and calls[0][0] == (5, N)
    assert _bits(out, tl.woodbury_chi2_logdet_pre(_t(R), tp)[0])


GRID_AXES = {
    "gls": (("M2", "SINI"), (0.26 + np.array([-1.0, 0.0, 1.0]) * 0.0075,
                             0.999 + np.array([-1.0, 0.0, 1.0]) * 0.0002)),
    "wls": (("F0", "F1"), None),
}


@pytest.fixture(scope="module")
def grid_cases(par_tim, tmp_path_factory):  # noqa: F811
    """{kind: (par, tim, grid names, points)}: the GLS grid on the par,
    the WLS grid on the par without ECORR and red noise, +-2 sigma."""
    par, tim = par_tim
    white = tmp_path_factory.mktemp("grid") / "white.par"
    white.write_text(white_par(B1855_LIKE_PAR))
    model, toas = get_model_and_toas(str(white), tim)
    names = ("F0", "F1")
    m = copy.deepcopy(model)
    WLSFitter(toas, m, device="cpu").fit_toas(maxiter=1)
    axes = [model.values[k] + np.array([-2.0, 0.0, 2.0])
            * m.uncertainties[k] for k in names]
    out = {}
    for kind, p, (nm, ax) in (("gls", par, GRID_AXES["gls"]),
                              ("wls", str(white), (names, axes))):
        out[kind] = (p, tim, nm, np.array(
            [(a, b) for a in ax[0] for b in ax[1]]))
    return out


def _refit_limits(kind, par, tim, names):
    """fit_tolerances of the refit's normal matrix (gridded parameters
    frozen) and the refit parameters' uncertainties."""
    model, toas = get_model_and_toas(par, tim)
    model.free_params = [p for p in model.free_params if p not in names]
    cls = GLSFitter if kind == "gls" else WLSFitter
    f = cls(toas, model, device="cpu")
    f.fit_toas(maxiter=3)
    cond = f.fit_health["cond_log10"]
    if kind == "wls":
        cond = tol.wls_normal_cond_log10(cond)
    return tol.fit_tolerances(cond), model.uncertainties


@pytest.mark.parametrize("kind", ["gls", "wls"])
def test_grid_matches_jax(grid_cases, kind):
    par, tim, names, pts = grid_cases[kind]
    jmodel, jtoas = jget_mt(par, tim)
    jchi2, jfit = jgrid.grid_chisq_vectorized(jtoas, jmodel, list(names),
                                              pts)
    model, toas = get_model_and_toas(par, tim)
    fn, fit_params, part = tgrid.make_grid_fn(toas, model, names,
                                              device="cpu")
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        chi2, fitted = (x.numpy() for x in fn(pts))
    assert fit_params == [p for p in jmodel.free_params if p not in names]
    assert part["n_linear"] + part["n_nonlinear"] == len(fit_params)
    lim, unc = _refit_limits(kind, par, tim, names)
    sig = [unc[k] for k in fit_params]
    assert np.max(np.abs(chi2 / np.asarray(jchi2) - 1)) \
        <= tol.REFIT_CHI2_REL
    assert tol.values_sigma_ulp(fitted, jfit, sig) <= lim["values_sigma"]
    # chunked equals unchunked within the same limits: not bit for bit,
    # because a batched BLAS call (bmm under vmap) may split its work
    # differently at another batch size, and a batch of one takes the
    # unbatched kernels; kappa amplifies the rounding
    c2, f2 = tgrid.grid_chisq_vectorized(toas, model, names, pts, chunk=4,
                                         device="cpu")
    assert np.max(np.abs(c2 / chi2 - 1)) <= tol.REFIT_CHI2_REL
    assert tol.values_sigma_ulp(f2, fitted, sig) <= lim["values_sigma"]
    # the tuple and derived variants are the same batched call
    c3, _ = tgrid.grid_chisq_tuple(toas, model, names, pts, device="cpu")
    assert np.array_equal(c3, chi2)
    axes = (np.unique(pts[:, 0]), np.unique(pts[:, 1]))
    mesh = tgrid.grid_chisq(toas, model, names, axes, device="cpu")
    assert mesh.shape == (3, 3) and np.array_equal(mesh.ravel(), chi2)
    d_chi2, pvals = tgrid.grid_chisq_derived(
        toas, model, names, [lambda a, b: a, lambda a, b: b], axes,
        device="cpu")
    jd_chi2, jpvals = jgrid.grid_chisq_derived(
        jtoas, jmodel, list(names), [lambda a, b: a, lambda a, b: b], axes)
    assert np.array_equal(pvals, np.asarray(jpvals))
    assert np.max(np.abs(d_chi2 / np.asarray(jd_chi2) - 1)) \
        <= tol.REFIT_CHI2_REL
    _, dpv = tgrid.grid_chisq_derived_tuple(
        toas, model, names, [lambda a, b: a, lambda a, b: b], pts,
        device="cpu")
    assert np.array_equal(dpv, pts)


def test_gridding_ecc_deepens_kepler(par_tim):  # noqa: F811
    model, toas = get_model_and_toas(*par_tim)
    depth = Residuals(toas, model, device="cpu").prepared.ctx["BinaryDD"]
    assert depth["kepler_iters"] == 4
    for names, want in ((["M2"], 4), (["ECC"], 10), (["ECC", "OM"], 10)):
        fn, fit_params, part = tgrid.make_grid_fn(toas, model, names,
                                                  device="cpu")
        ctx = fn.resids.prepared.ctx["BinaryDD"]
        assert ctx["kepler_iters"] == want
        assert not set(names) & set(fit_params)
        assert "BinaryDD" not in part["frozen"]


def test_grid_entry_points_default_to_cuda(par_tim, monkeypatch):  # noqa: F811
    from pint_tpu_torch.downhill import DownhillGLSFitter, DownhillWLSFitter

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, toas = get_model_and_toas(*par_tim)
    pts = np.array([[0.26, 0.999]])
    for make in (lambda: tgrid.make_grid_fn(toas, model, ["M2", "SINI"]),
                 lambda: tgrid.grid_chisq_vectorized(
                     toas, model, ["M2", "SINI"], pts),
                 lambda: tgrid.grid_chisq_tuple(toas, model, ["M2", "SINI"],
                                                pts, device="cuda"),
                 lambda: DownhillGLSFitter(toas, model),
                 lambda: DownhillWLSFitter(toas, model)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
