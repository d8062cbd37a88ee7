"""The template layer (``pint_tpu_torch.templates``) against pint_tpu's on
the CPU, and kernel K12's op, batching rule and backward through their
plain versions.

- every primitive's density and ``NormAngles`` against JAX's, within
  ``tolerances.PHOTON_DENSITY_REL``;
- K12's plain density from the packed rows repeats the primitives'
  mixture bit for bit;
- ``lnlike_fn`` and its gradient against ``jax.value_and_grad``,
  weighted and unweighted, within ``photon_lnlike_limit`` and
  ``photon_grad_limit``;
- the op ``pint_tpu_torch::photon_lnlike`` under ``torch.func.vmap`` is
  one plain call for the batch (a spy), equal row by row; its backward
  (the plain K12b, ``photon_lnlike_bwd_plain``) against autograd of the
  plain forward, within ``tolerances.k12b_limit``;
- ``LCFitter.fit`` against the nearest of JAX's own fit and its fits
  under the perturbation behind ``tolerances.lcfit_limits`` (a smooth
  template and a two-sided one), and ``param_uncertainties`` against
  JAX's;
- the template I/O and ``convert.template_to_arrays`` /
  ``template_from_arrays`` round trips.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import pint_tpu.templates as jt
import pint_tpu_torch.templates as tt
from pint_tpu_torch import tolerances as tol
from pint_tpu_torch.convert import template_from_arrays, template_to_arrays
from tools import export_torch_photon_case as case

# one intra-op thread: the tests run at small sizes, and pytest-xdist's
# workers share the machine's cores
torch.set_num_threads(1)

#: (class name, constructor arguments) of every primitive
PRIMS = {
    "LCGaussian": {"sigma": 0.03, "loc": 0.3},
    "LCLorentzian": {"gamma": 0.03, "loc": 0.7},
    "LCVonMises": {"kappa": 40.0, "loc": 0.1},
    "LCTopHat": {"width": 0.1, "loc": 0.45},
    "LCHarmonic": {"order": 2, "loc": 0.2},
    "LCGaussian2": {"sigma1": 0.02, "sigma2": 0.05, "loc": 0.6},
    "LCLorentzian2": {"gamma1": 0.03, "gamma2": 0.06, "loc": 0.85},
    "LCSkewGaussian": {"sigma": 0.04, "shape": 3.0, "loc": 0.5},
    "LCKing": {"sigma": 0.03, "gamma": 2.5, "loc": 0.35},
}


def _phases(n=500, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-0.5, 1.5, n - 4),
                           [0.0, 0.5, -0.25, 0.999999]])


def _pair(name, **kw):
    args = dict(PRIMS[name], **kw)
    return getattr(jt, name)(**args), getattr(tt, name)(**args)


def _five(norms=(0.15, 0.1, 0.1, 0.08, 0.12)):
    """(JAX template, port template) over every type K12 covers."""
    names = ["LCGaussian", "LCLorentzian", "LCVonMises", "LCGaussian2",
             "LCLorentzian2"]
    pairs = [_pair(n) for n in names]
    return (jt.LCTemplate([p[0] for p in pairs], norms=list(norms)),
            tt.LCTemplate([p[1] for p in pairs], norms=list(norms)))


def _sample(template, n, seed):
    """(phases, weights) as the weighted likelihood models them: a
    weight from Beta(1, 2) per photon; with probability w the phase is
    drawn from a JAX template's density by rejection, else uniform."""
    rng = np.random.default_rng(seed)
    grid = np.linspace(0, 1, 5001)
    fmax = 1.01 * float(np.max(np.asarray(template.density(grid))))
    out = np.empty(0)
    while out.size < n:
        c = rng.uniform(size=4 * n)
        keep = rng.uniform(size=4 * n) * fmax < np.asarray(
            template.density(c))
        out = np.concatenate([out, c[keep]])
    w = rng.beta(1.0, 2.0, n)
    pulsed = rng.uniform(size=n) < w
    return np.where(pulsed, out[:n], rng.uniform(size=n)), w


@pytest.mark.parametrize("name", list(PRIMS) + ["LCEmpiricalFourier",
                                                "LCKernelDensity"])
def test_primitive_density_matches_jax(name):
    phi = _phases()
    if name in ("LCEmpiricalFourier", "LCKernelDensity"):
        sample = _phases(300, seed=1) % 1.0
        kw = {"nharm": 8} if name == "LCEmpiricalFourier" else {}
        j = getattr(jt, name)(phases=sample, **kw)
        t = getattr(tt, name)(phases=sample, **kw)
        p = np.array([0.013])
    else:
        j, t = _pair(name)
        p = np.array(j.init_params(), np.float64)
    want = np.asarray(j.density(jnp.asarray(phi), jnp.asarray(p)))
    got = t.density(torch.tensor(phi), torch.tensor(p)).numpy()
    assert tol.vector_rel(got, want) <= tol.PHOTON_DENSITY_REL


def test_norm_angles_match_jax():
    norms = np.array([0.3, 0.2, 0.1])
    ang = jt.NormAngles(3).from_norms(norms)
    assert np.array_equal(tt.NormAngles(3).from_norms(norms), ang)
    want = np.asarray(jt.NormAngles(3).to_norms(jnp.asarray(ang)))
    got = tt.NormAngles(3).to_norms(torch.tensor(ang)).numpy()
    assert tol.vector_rel(got, want) <= 1e-15
    assert np.allclose(got, norms, rtol=1e-8)


def test_k12_plain_density_is_the_mixture():
    """K12's plain density from the packed rows gives the primitives'
    mixture (LCTemplate.density's loop) bit for bit."""
    _, t = _five()
    phi = torch.tensor(_phases(800) % 1.0)
    p = torch.tensor(t.params)
    types, rows, bg = tt.pack_template(t, p)
    got = tt.photon_density_plain(phi[None], types, rows[None],
                                  bg.reshape(1))[0]
    norms, pp = t._split(p)
    want = 1.0 - torch.sum(norms)
    for i, prim in enumerate(t.primitives):
        want = want + norms[i] * prim.density(phi, pp[i])
    assert torch.equal(got, want)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("which", ["three", "five"])
def test_lnlike_and_grad_match_jax(weighted, which):
    j, t = _five()
    if which == "three":
        j = jt.LCTemplate(j.primitives[:3], norms=[0.2, 0.15, 0.1])
        t = tt.LCTemplate(t.primitives[:3], norms=[0.2, 0.15, 0.1])
    phases, w = _sample(j, 1500, seed=2)
    w = w if weighted else None
    params = np.array(j.params) * (1.0 + 0.01 * np.arange(len(j.params))
                                   / len(j.params))
    jv, jg = jax.value_and_grad(j.lnlike_fn(phases, w))(jnp.asarray(params))
    p = torch.tensor(params, requires_grad=True)
    v = t.lnlike_fn(phases, w, device="cpu")(p)
    (g,) = torch.autograd.grad(v, p)
    types, rows, bg = tt.pack_template(t, torch.tensor(params))
    wt = None if w is None else torch.tensor(w)
    abs_sum = tt.photon_lnlike_plain(torch.tensor(phases)[None], wt, types,
                                     rows[None], bg.reshape(1),
                                     absolute=True)
    assert abs(float(v) - float(jv)) <= tol.photon_lnlike_limit(
        len(phases), float(abs_sum))
    ph = torch.tensor(phases)

    def per_photon(q):  # log x_i, whose gradients are the terms
        ty, ro, b = tt.pack_template(t, q)
        f = tt.photon_density_plain(ph[None], ty, ro[None], b.reshape(1))[0]
        return torch.log(f if wt is None else wt * f + (1.0 - wt))

    terms = torch.func.jacrev(per_photon)(torch.tensor(params))
    abs_terms = terms.abs().sum(dim=0).numpy()
    assert np.all(np.abs(g.numpy() - np.asarray(jg))
                  <= tol.photon_grad_limit(abs_terms))


def _k12_inputs(w_rows, n=700, seed=4):
    _, t = _five()
    rng = np.random.default_rng(seed)
    frac = torch.tensor(rng.uniform(-0.5, 0.5, (w_rows, n)))
    wts = torch.tensor(rng.beta(1.0, 2.0, n))
    p = torch.tensor(t.params)[None] * torch.tensor(
        1.0 + 0.02 * rng.standard_normal((w_rows, len(t.params))))
    types, rows, bg = tt.pack_template(t, p)
    return frac, wts, types, rows, bg


@pytest.mark.parametrize("walkers", [8, 2])
def test_k12_op_vmap_is_one_call(monkeypatch, walkers):
    frac, wts, types, rows, bg = _k12_inputs(walkers)
    calls = []
    inner = tt.photon_lnlike_plain

    def spy(*a, **k):
        calls.append(a[0].shape)
        return inner(*a, **k)

    monkeypatch.setattr(tt, "photon_lnlike_plain", spy)
    got = torch.func.vmap(lambda f, r, b: tt._k12_op(
        f[None], wts, types, r[None], b.reshape(1), None, True)[0])(
            frac, rows, bg)
    assert len(calls) == 1 and calls[0] == (walkers, frac.shape[1])
    want = torch.stack([inner(frac[i:i + 1], wts, types, rows[i:i + 1],
                              bg[i:i + 1], None, True)[0]
                        for i in range(walkers)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("weighted", [True, False])
def test_k12_op_backward_is_plain_k12b(weighted):
    """The op's backward (the plain K12b, analytic) against autograd of
    the plain forward, per entry within k12b_limit; a shared template row
    takes the walkers' sum."""
    frac, wts, types, rows, bg = _k12_inputs(3)
    wts = wts if weighted else None
    for shared in (False, True):
        r = (rows[:1] if shared else rows).clone().requires_grad_(True)
        b = (bg[:1] if shared else bg).clone().requires_grad_(True)
        gout = torch.tensor([1.0, -0.5, 2.0])
        out = tt._k12_op(frac, wts, types, r, b, None, True)
        gr, gb = torch.autograd.grad(out, (r, b), gout)
        r2 = r.detach().clone().requires_grad_(True)
        b2 = b.detach().clone().requires_grad_(True)
        out2 = tt.photon_lnlike_plain(frac, wts, types, r2, b2, None, True)
        assert torch.equal(out, out2)
        wr, wb = torch.autograd.grad(out2, (r2, b2), gout)
        absd = tt.photon_lnlike_bwd_plain(frac, wts, types,
                                          r.detach().expand(3, -1, -1),
                                          b.detach().expand(3), True,
                                          absolute=True)
        absd = (absd * gout.abs()[:, None]).sum(0) if shared \
            else absd * gout.abs()[:, None]
        lim = tol.k12b_limit(frac.shape[1], absd.numpy())
        got = torch.cat([gb.reshape(-1, 1), gr.reshape(gr.shape[0], -1)],
                        dim=1).numpy()
        want = torch.cat([wb.reshape(-1, 1), wr.reshape(wr.shape[0], -1)],
                         dim=1).numpy()
        assert np.all(np.abs(got - want) <= lim.reshape(got.shape))


def _lcfit_templates(lorentzian, **widths):
    """(true JAX template, start(pkg)) of the template-fit tests: a
    Gaussian, ``lorentzian`` and a von Mises peak, the start 0.005 turns
    and ~10 % off."""
    true = jt.LCTemplate([jt.LCGaussian(0.04, 0.3),
                          getattr(jt, lorentzian)(*widths["true"], 0.55),
                          jt.LCVonMises(30.0, 0.8)], norms=[0.25, 0.2, 0.15])

    def start(pkg=jt):
        return pkg.LCTemplate([pkg.LCGaussian(0.045, 0.305),
                               getattr(pkg, lorentzian)(*widths["start"],
                                                        0.545),
                               pkg.LCVonMises(27.0, 0.805)],
                              norms=[0.22, 0.18, 0.13])

    return true, start


def _check_lcfit(start, phases, w):
    """The port's ``LCFitter.fit`` against JAX's: within
    ``tolerances.lcfit_limits`` of the nearest of JAX's own fit and its
    fits under the perturbation behind the limit (one a seed of
    ``LC_SEEDS``), the perturbation itself as large as the port's
    disagreement at the start and at JAX's fit, and the Hessian's sigma
    at JAX's parameters.  Returns what a further check needs."""
    jp, jl = case.lc_fit(start, phases, w)
    jf = jt.LCFitter(start(), phases, w)
    jf.template.params = np.array(jp)
    jsig = np.asarray(jf.param_uncertainties())
    lnx_abs, grad_abs = case.lc_sums(start(), phases, w, jp)
    fits, fits_lnl = case.lc_perturbed_fits(start, phases, w, lnx_abs,
                                            grad_abs)
    lim = tol.lcfit_limits(fits, fits_lnl, jp, jl, jsig)
    outcomes = (np.vstack([jp[None], fits]), np.concatenate([[jl], fits_lnl]))
    tf = tt.LCFitter(start(tt), phases, w, device="cpu")
    vg = jax.jit(jax.value_and_grad(lambda p: -jf._lnlike(p)))
    for p in (np.array(start().params), jp):
        jv, jg = vg(jnp.asarray(p))
        tv, tg = tf._val_grad(p)
        assert abs(float(tv) - float(jv)) <= tol.LCFIT_VALUE_REL * lnx_abs
        assert np.all(np.abs(tg.numpy() - np.asarray(jg))
                      <= tol.LCFIT_GRAD_REL * grad_abs)
    tp, tl = tf.fit()
    assert tf.nit > 0
    assert tol.lcfit_nearest(tp, tl, *outcomes, lim) <= 1.0
    assert abs(tf.lnlike() - tl) <= 1e-9
    # the Hessian's sigma at the same parameters
    tf.template.params = np.array(jp)
    assert tol.vector_rel(tf.param_uncertainties(), jsig) <= 1e-8
    return grad_abs, outcomes, lim


def test_lcfitter_matches_jax():
    """The two-sided Lorentzian's template: its density jumps at the
    peak, and JAX's own fit lands 0.08 sigma off under some seeds'
    perturbations, so the port is held to the nearest of JAX's fits."""
    true, start = _lcfit_templates("LCLorentzian2", true=(0.05, 0.07),
                                   start=(0.055, 0.065))
    phases, w = _sample(true, 3000, seed=5)
    _check_lcfit(start, phases, w)


def test_lcfitter_smooth_matches_jax():
    """A template whose lnL is smooth: JAX's perturbed fits stay within
    ~1e-7 sigma, and a fit whose gradient has one entry wrong by 1e-5 of
    its sum of |terms| lands far outside the limit."""
    true, start = _lcfit_templates("LCLorentzian", true=(0.05,),
                                   start=(0.055,))
    phases, w = _sample(true, 3000, seed=5)
    grad_abs, outcomes, lim = _check_lcfit(start, phases, w)

    def wrong(v, g):
        g = np.array(g)
        g[3] += case.LC_WRONG_REL * grad_abs[3]  # the Gaussian's sigma
        return v, g

    wp, wl = case.lc_fit(start, phases, w, wrong)
    assert tol.lcfit_nearest(wp, wl, *outcomes, lim) > 100.0


def test_template_io_roundtrip(tmp_path):
    jtpl = jt.LCTemplate([jt.LCGaussian(0.02, 0.3), jt.LCGaussian(0.05,
                                                                  0.7)],
                         norms=[0.4, 0.3])
    ttpl = tt.LCTemplate([tt.LCGaussian(0.02, 0.3), tt.LCGaussian(0.05,
                                                                  0.7)],
                         norms=[0.4, 0.3])
    assert tt.prof_string(ttpl) == jt.prof_string(jtpl)
    path = tmp_path / "t.gauss"
    tt.write_template(ttpl, path)
    back, jback = tt.read_template(path), jt.read_template(path)
    assert np.array_equal(back.params, np.asarray(jback.params))
    assert tol.vector_rel(tt.read_gaussfitfile(path, 64, device="cpu"),
                          np.asarray(jt.read_gaussfitfile(path, 64))) \
        <= tol.PHOTON_DENSITY_REL
    fpath = tmp_path / "t.fourier"
    jt.LCEmpiricalFourier(phases=_phases(200) % 1, nharm=5).to_file(fpath)
    assert np.array_equal(tt.read_template(fpath).primitives[0].alphas,
                          jt.read_template(fpath).primitives[0].alphas)
    for kind in (jt.LCGaussian, jt.LCLorentzian, jt.LCVonMises):
        for src in (jt.LCGaussian(0.03, 0.2), jt.LCVonMises(50.0, 0.4)):
            got = tt.convert_primitive(
                getattr(tt, type(src).__name__)(*src.init_params()),
                getattr(tt, kind.__name__))
            want = jt.convert_primitive(src, kind)
            assert np.allclose(got.init_params(), want.init_params(),
                               rtol=1e-15)


def test_template_arrays_roundtrip():
    j, _ = _five()
    j2 = jt.LCTemplate([jt.LCTopHat(0.1, 0.4),
                        jt.LCEmpiricalFourier(phases=_phases(100) % 1,
                                              nharm=4)],
                       norms=[0.3, 0.7])
    phi = _phases(300) % 1.0
    for jtpl in (j, j2):
        arrays = template_to_arrays(jtpl)
        t = template_from_arrays(arrays)
        assert np.array_equal(t.params, np.asarray(jtpl.params))
        got = t.density(torch.tensor(phi)).numpy()
        assert tol.vector_rel(got, np.asarray(jtpl.density(phi))) \
            <= tol.PHOTON_DENSITY_REL
        again = template_to_arrays(t)
        assert all(np.array_equal(again[k], arrays[k]) for k in arrays)
    bins = np.linspace(1.0, 2.0, 16)
    assert np.array_equal(template_from_arrays(template_to_arrays(bins)),
                          bins)
