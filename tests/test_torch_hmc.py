"""The port's GWB posterior and sampler (``pint_tpu_torch.gw.hmc``)
against pint_tpu at small size, on the CPU.

Two arrays, made with numpy from fixed seeds by ``pint_tpu.simulation``
and carried across as plain arrays
(``tools/export_torch_pta_case.pta_case_arrays`` ->
``convert.pta_case_from_arrays``):

- ``small``: tests/test_kron_hmc.py:64's 4 pulsars x 40 TOAs with
  4-mode red noise and a GWB over 4 modes;
- ``ragged``: three 40-TOA pulsars with red noise and one 35-TOA pulsar
  without, which samples no parameter.

A third, ``loud`` (24 pulsars, a GWB at 1e-13), goes through the port
alone: its sampled amplitude is held to its own likelihood grid's peak.

Both go through pint_tpu's ``GWBPosterior(CommonProcess(pairs,
nmodes=4))`` and the port's with ``device="cpu"`` (the kernels' plain
versions).  Tolerances: lnprob 1e-10 relative and its gradient within
1e-10 of max|g| (the reference's kron == dense pin,
tests/test_kron_hmc.py:341-355); the per-pulsar stage (plain K5/K5b)
1e-10 against JAX's per-pulsar ``one`` and its ``jax.vjp``; the
injected-draw trajectory 1e-7 in units of the scales, lnprob and step
sizes 1e-9 relative, the same accept decisions.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pint_tpu import compile_cache
from pint_tpu.gw import CommonProcess as JCommonProcess
from pint_tpu.gw import GWBPosterior as JGWBPosterior
from pint_tpu.gw import run_nuts as jrun_nuts
from pint_tpu.models.builder import get_model
from pint_tpu.simulation import (add_gwb, make_fake_pta,
                                 make_fake_toas_uniform, pta_injection_seed)
from pint_tpu_torch import tolerances as tol
from pint_tpu_torch.convert import PTA4_WIDE, load_arrays, \
    pta_case_from_arrays
from pint_tpu_torch.gw.common import CommonProcess
from pint_tpu_torch.gw.hmc import GWBPosterior, run_nuts
from pint_tpu_torch.iterate import iterate_fixed
from pint_tpu_torch.linalg import (KronGram, _k5_shape,
                                   kron_pulsar_bwd_plain, kron_pulsar_plain,
                                   kron_pulsar_terms)
from tools.export_torch_hmc_case import replay_draws
from tools.export_torch_pta_case import pta_case_arrays

NMODES = 4
GWB_GAMMA = 13.0 / 3.0
RED = "TNRedAmp -13.5\nTNRedGam 4.0\nTNRedC 4\n"
CPU = "cpu"


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


def _small():
    pairs = make_fake_pta(4, 40, seed=5, extra_par=RED)
    add_gwb([t for _, t in pairs], [m for m, _ in pairs], 3e-14,
            rng=pta_injection_seed(5, 4), nmodes=4)
    return pairs


def _ragged():
    pairs = (make_fake_pta(3, 40, seed=7, extra_par=RED, name_prefix="A")
             + make_fake_pta(4, 35, seed=8, name_prefix="C")[3:4])
    add_gwb([t for _, t in pairs], [m for m, _ in pairs], 3e-14, rng=12,
            nmodes=4)
    return pairs


@functools.lru_cache(maxsize=None)
def _posteriors(name):
    """(pint_tpu's, the port's) posterior of one array, built once."""
    jpairs = {"small": _small, "ragged": _ragged}[name]()
    tpairs = pta_case_from_arrays(pta_case_arrays(jpairs))
    return (JGWBPosterior(JCommonProcess(jpairs, nmodes=NMODES, kron=True)),
            GWBPosterior(CommonProcess(tpairs, nmodes=NMODES, device=CPU)))


@pytest.fixture(scope="module", params=["small", "ragged"])
def posteriors(request):
    return (request.param,) + _posteriors(request.param)


@pytest.fixture(scope="module")
def small_posteriors():
    return _posteriors("small")


def _thetas(post):
    return np.concatenate([post.center()[None],
                           post.initial_chains(6, seed=1, ball=1.0)])


def test_layout(posteriors):
    name, jpost, tpost = posteriors
    assert tpost.param_names == jpost.param_names
    assert tpost.noise_params == jpost.noise_params
    assert np.array_equal(tpost.bounds, jpost.bounds)
    assert np.array_equal(tpost.scales, jpost.scales)
    assert np.array_equal(tpost.center(), jpost.center())
    for kw in ({}, {"seed": 3, "ball": 1.0}):
        assert np.array_equal(tpost.initial_chains(5, **kw),
                              jpost.initial_chains(5, **kw))
    if name == "ragged":
        # the pulsar without red noise samples nothing
        assert tpost.ndim == 2 + 2 * 3
        assert all(k < 3 for k, _ in tpost.noise_params)


def test_noise_weights_match_each_pulsar(posteriors):
    """The batched red-noise weights equal every pulsar's own
    ``noise_weights_fn`` at each chain's values, and the tail of each
    padded row (offset, timing columns, padding) is the build's."""
    _, _, tpost = posteriors
    theta = tpost.initial_chains(3, seed=4, ball=1.0)
    phi = _np(tpost.phi_noise_at(torch.as_tensor(theta)))
    phi0 = _np(tpost.phi0)
    for c in range(theta.shape[0]):
        for k, resid in enumerate(tpost.crn.resids):
            prep = resid.prepared
            want = _np(prep.noise_weights_fn(prep.values_dict(
                tpost.values_at(theta[c], k))))
            nb = len(want)
            np.testing.assert_allclose(phi[c, k, :nb], want, rtol=1e-14,
                                       atol=0.0, err_msg=f"{c} {k}")
            assert np.array_equal(phi[c, k, nb:], phi0[k, nb:])


def test_lnprob_and_grad_match_jax(posteriors):
    _, jpost, tpost = posteriors
    theta = _thetas(tpost)
    data = jpost.data()
    vg = jax.vmap(jax.value_and_grad(lambda q: jpost.lnprob(q, data)))
    lj, gj = (np.asarray(a) for a in vg(jnp.asarray(theta)))
    lt, gt = (_np(a) for a in tpost.value_and_grad(torch.as_tensor(theta)))
    assert np.all(np.abs(lt / lj - 1) <= tol.GW_LNLIKE_REL), lt / lj - 1
    for i in range(len(theta)):
        err = np.max(np.abs(gt[i] - gj[i])) / np.max(np.abs(gj[i]))
        assert err <= tol.HMC_GRAD_REL, (i, err)
    # one row alone gives the same as in the batch
    l1, g1 = tpost.value_and_grad(torch.as_tensor(theta[2:3]))
    assert abs(float(l1[0]) / lt[2] - 1) <= 1e-13
    assert np.max(np.abs(_np(g1)[0] - gt[2])) <= 1e-12 * np.max(
        np.abs(gt[2]))


def test_out_of_bounds_is_minus_inf(small_posteriors):
    jpost, tpost = small_posteriors
    th = tpost.center()
    th[0] = -30.0
    lt, gt = tpost.value_and_grad(torch.as_tensor(th[None]))
    lj, gj = jax.value_and_grad(lambda q: jpost.lnprob(q, jpost.data()))(
        jnp.asarray(th))
    assert float(lt[0]) == float(lj) == -np.inf
    assert np.array_equal(_np(gt)[0], np.asarray(gj))


# --------------------------------------------------------------------------
# the per-pulsar stage: plain K5 / K5b against JAX's per-pulsar `one`
# --------------------------------------------------------------------------

def _jax_one(g_uu, g_uf, g_ff, b_u, b_f, rr, ld_white, phi_row):
    """pint_tpu linalg.py:701-713's per-pulsar reduction, verbatim."""
    phi_row = jnp.maximum(phi_row, 1e-30)
    cap = g_uu + jnp.diag(1.0 / phi_row)
    cf = jax.scipy.linalg.cho_factor(cap, lower=True)
    x_u = jax.scipy.linalg.cho_solve(cf, b_u)
    x_uf = jax.scipy.linalg.cho_solve(cf, g_uf)
    chi2_a = rr - b_u @ x_u
    x_a = b_f - g_uf.T @ x_u
    m_a = g_ff - g_uf.T @ x_uf
    ld_a = (ld_white + jnp.sum(jnp.log(phi_row))
            + 2.0 * jnp.sum(jnp.log(jnp.diag(cf[0]))))
    return chi2_a, x_a, m_a, ld_a


def test_plain_k5_k5b_against_jax_one(small_posteriors):
    """The posterior's grams with three chains of perturbed weights
    (log10 A +/- 0.5, gamma +/- 0.5 on each red-noise block): the plain
    K5 outputs against JAX's ``one``, and the plain K5b against
    ``jax.vjp`` of it and against autograd through the plain forward,
    for random cotangents."""
    _, tpost = small_posteriors
    rng = np.random.default_rng(11)
    th = np.repeat(tpost.center()[None], 3, axis=0)
    th[:, 2:] += rng.uniform(-0.5, 0.5, th[:, 2:].shape)
    phi = tpost.phi_noise_at(torch.as_tensor(th))
    pre = tpost.gram
    chi2, x, m, ld, L, X = kron_pulsar_plain(pre, phi)
    g = [_np(t) for t in pre]
    one = jax.vmap(jax.vmap(_jax_one, in_axes=(0,) * 8),
                   in_axes=(None,) * 7 + (0,))
    ref = one(*g, _np(phi))
    for got, want, name in zip((chi2, x, m, ld), ref, ("chi2", "x", "m",
                                                       "ld")):
        assert tol.vector_rel(_np(got), np.asarray(want)) \
            <= tol.KRON_PULSAR_REL, name
    cots = [rng.standard_normal(t.shape) for t in (chi2, x, m, ld)]
    _, vjp = jax.vjp(lambda p: one(*g, p), _np(phi))
    (gj,) = vjp(tuple(jnp.asarray(c) for c in cots))
    ct = [torch.as_tensor(c) for c in cots]
    gk = kron_pulsar_bwd_plain(phi, L, X, *ct)
    assert tol.vector_rel(_np(gk), np.asarray(gj)) <= tol.KRON_PULSAR_REL
    # autograd through the plain forward's cholesky_ex / cholesky_solve
    p_ = phi.clone().requires_grad_(True)
    outs = kron_pulsar_plain(pre, p_)[:4]
    (ga,) = torch.autograd.grad(outs, p_, ct)
    assert tol.vector_rel(_np(gk), _np(ga)) <= tol.KRON_PULSAR_REL
    # and through the autograd.Function
    p_ = phi.clone().requires_grad_(True)
    (gf,) = torch.autograd.grad(kron_pulsar_terms(pre, p_), p_, ct)
    assert torch.equal(gf, gk)


def _wide_stage(name):
    """(grams, phi) of the per-pulsar stage at a wide width: the wide
    PTA case's posterior (``pta4_wide.npz``, nb = 203) at its 4
    reference theta, or a numpy-seeded gram of 2 pulsars at nb = 470,
    m2 = 28 (400 ECORR epochs and 30 red-noise modes) with 2 chains of
    weights in [1e-16, 1e-12]."""
    if name == "pta4_wide":
        arrays = load_arrays(PTA4_WIDE)
        crn = CommonProcess(pta_case_from_arrays(arrays),
                            nmodes=int(arrays["ref_nmodes"]), device=CPU)
        post = GWBPosterior(crn)
        return post.gram, post.phi_noise_at(
            torch.as_tensor(arrays["ref_theta"]))
    pre = _random_grams(470, p=2, nb=470, m2=28, n=570, scale=1e12)
    rng = np.random.default_rng(471)
    return pre, torch.as_tensor(10.0 ** rng.uniform(-16, -12, (2, 2, 470)))


@pytest.mark.parametrize("name", ["pta4_wide", "nb470"])
def test_plain_k5_k5b_wide_against_jax_one(name):
    """The oracle of the wide forms' card tests: at the widths K5w and
    K5bw take, the plain K5 outputs against JAX's ``one``, and the plain
    K5b against ``jax.vjp`` of it and against autograd through the plain
    forward, for random cotangents."""
    pre, phi = _wide_stage(name)
    assert _k5_shape(pre.g_uu.shape[-1], pre.g_ff.shape[-1]) \
        == ("wide", "wide")
    chi2, x, m, ld, L, X = kron_pulsar_plain(pre, phi)
    g = [_np(t) for t in pre]
    one = jax.vmap(jax.vmap(_jax_one, in_axes=(0,) * 8),
                   in_axes=(None,) * 7 + (0,))
    ref = one(*g, _np(phi))
    for got, want, nm in zip((chi2, x, m, ld), ref, ("chi2", "x", "m",
                                                     "ld")):
        assert tol.vector_rel(_np(got), np.asarray(want)) \
            <= tol.KRON_PULSAR_REL, nm
    rng = np.random.default_rng(12)
    cots = [rng.standard_normal(t.shape) for t in (chi2, x, m, ld)]
    _, vjp = jax.vjp(lambda p: one(*g, p), _np(phi))
    (gj,) = vjp(tuple(jnp.asarray(c) for c in cots))
    ct = [torch.as_tensor(c) for c in cots]
    gk = kron_pulsar_bwd_plain(phi, L, X, *ct)
    assert tol.vector_rel(_np(gk), np.asarray(gj)) <= tol.KRON_PULSAR_REL
    p_ = phi.clone().requires_grad_(True)
    (ga,) = torch.autograd.grad(kron_pulsar_plain(pre, p_)[:4], p_, ct)
    assert tol.vector_rel(_np(gk), _np(ga)) <= tol.KRON_PULSAR_REL


def _random_grams(seed, p=3, nb=5, m2=4, n=12, scale=1.0):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((p, n, nb + m2 + 1))
    w = rng.uniform(0.5, 2.0, (p, n)) * scale
    gram = np.matmul((t * w[..., None]).transpose(0, 2, 1), t)
    u, f = slice(0, nb), slice(nb, nb + m2)
    return KronGram(*(torch.as_tensor(a.copy()) for a in (
        gram[:, u, u], gram[:, u, f], gram[:, f, f], gram[:, u, -1],
        gram[:, f, -1], gram[:, -1, -1], rng.standard_normal(p))))


def test_kron_pulsar_terms_gradcheck():
    """torch.autograd.gradcheck of the autograd.Function at nb = 5,
    m2 = 4, two chains; weights below the 1e-30 floor get no gradient,
    and a gram that requires grad raises."""
    pre = _random_grams(0)
    rng = np.random.default_rng(1)
    phi = torch.as_tensor(10.0 ** rng.uniform(-1.0, 1.0, (2, 3, 5)),
                          dtype=torch.float64).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda q: kron_pulsar_terms(pre, q), (phi,), eps=1e-6, atol=1e-7,
        rtol=1e-6)
    floor = phi.detach().clone()
    floor[0, 1, 2] = 0.0
    floor.requires_grad_(True)
    out = kron_pulsar_terms(pre, floor)
    (g,) = torch.autograd.grad(sum(o.sum() for o in out), floor)
    assert g[0, 1, 2] == 0.0 and torch.all(g[1] != 0.0)
    bad = KronGram(*(t.clone().requires_grad_(i == 0)
                     for i, t in enumerate(pre)))
    with pytest.raises(ValueError, match="gram requires grad"):
        kron_pulsar_terms(bad, phi)


def test_k5_shared_memory_and_width_limit():
    """K5's block holds the capacity padded to a multiple of 8 and its
    right-hand sides to one of 16 (row strides + 4), and below 3 block
    rows the diagonal blocks' inverses: 53,248 bytes at the case's
    nb = 63, m2 = 28.  A pulsar too wide for one block's shared memory
    takes the wide forms (K5w/K5bw; their panel width and their own
    limit are the library's, checked on the card in
    test_torch_cuda.py)."""
    from pint_tpu_torch.linalg import K5_SHARED_BYTES, _k5_shape, \
        k5_shared_bytes

    # K5b at least: 36 tiles of 96 doubles and two 64-vectors
    assert k5_shared_bytes(63, 28) == (53248, 8 * (36 * 96 + 2 * 64))
    assert k5_shared_bytes(29, 28)[0] == 8 * (32 * 36 + 32 * 36)
    assert k5_shared_bytes(16, 3)[0] == 8 * (16 * 20 + 16 * 20 + 2 * 96)
    assert _k5_shape(100, 28) == ("narrow", "narrow")
    assert max(k5_shared_bytes(144, 28)) <= K5_SHARED_BYTES
    assert _k5_shape(144, 28) == ("narrow", "narrow")
    assert k5_shared_bytes(145, 28)[0] > K5_SHARED_BYTES
    assert _k5_shape(145, 28) == ("wide", "narrow")
    assert _k5_shape(470, 28) == ("wide", "wide")
    assert _k5_shape(4000, 28) == ("wide", "wide")


def test_k5b_takes_every_shape_of_its_first_form():
    """The narrow K5b's tiled layout takes every (nb, m2) whose
    nb (nb + m2) doubles, its first form's shared memory, fit one block,
    so no shape moved to K5bw when K5b was redesigned."""
    from pint_tpu_torch.linalg import K5_SHARED_BYTES, _k5_shape

    for m2 in (0, 1, 2, 5, 14, 28, 40, 60, 100, 400, 3000):
        for nb in range(1, 200):
            if 8 * (nb * nb + nb * m2) <= K5_SHARED_BYTES:
                assert _k5_shape(nb, m2)[1] == "narrow", (nb, m2)


# --------------------------------------------------------------------------
# the sampler
# --------------------------------------------------------------------------

def _k6_case(rng, c, nd, n_leap, n_draws=3):
    """A K6 state's start and ``n_draws`` draws of random numbers and
    gradients; chains go inactive at different steps (the first after
    one step, the last after all of them)."""
    im = torch.tensor(rng.uniform(0.1, 0.3, nd))
    x0, g0 = (torch.tensor(rng.standard_normal((c, nd))) for _ in range(2))
    lnp0 = torch.tensor(1e5 + rng.standard_normal(c))
    draws = []
    for _ in range(n_draws):
        n = rng.integers(1, n_leap + 1, c)
        n[0], n[-1] = 1, n_leap
        draws.append((torch.tensor(rng.standard_normal((c, nd))),
                      torch.tensor(n), torch.tensor(rng.uniform(0, 1, c)),
                      [(torch.tensor(1e5 + rng.standard_normal(c)),
                        torch.tensor(rng.standard_normal((c, nd))))
                       for _ in range(n_leap)]))
    return im, x0, g0, lnp0, draws


@pytest.mark.parametrize("n_leap,nd", [(1, 1), (4, 40), (12, 138),
                                       (4, 300)])
def test_k6_fused_entry_points_equal_plain_stages(n_leap, nd):
    """Three draws (two adapting: warmup to warmup, then warmup to
    sampling) through the fused entry points (``nuts_draw_start``,
    ``nuts_leap_next``, ``nuts_draw_finish``) on CPU tensors against pre,
    post and end in turn: every buffer of the state bit for bit after
    each draw."""
    from pint_tpu_torch.gw import hmc

    c = 5
    im, x0, g0, lnp0, draws = _k6_case(np.random.default_rng(nd), c, nd,
                                       n_leap)
    states = [hmc.NutsState(x0.clone(), g0.clone(), lnp0.clone(), im, 0.1)
              for _ in range(2)]
    for d, (z, n, u, grads) in enumerate(draws):
        for fused, st in enumerate(states):
            st.z.copy_(z)
            st.n_steps.copy_(n)
            st.u.copy_(u)
            if fused:
                hmc.nuts_draw_start(st)
            for i in range(n_leap):
                if not fused:
                    hmc.nuts_leap_pre_plain(st, i)
                st.lnp_n.copy_(grads[i][0])
                st.gn.copy_(grads[i][1])
                if not fused:
                    hmc.nuts_leap_post_plain(st, i)
                elif i + 1 < n_leap:
                    hmc.nuts_leap_next(st, i)
            if fused:
                hmc.nuts_draw_finish(st, n_leap - 1, d < 2, d + 1 < 2, 0.8,
                                     d)
            else:
                hmc.nuts_draw_end_plain(st, d < 2, d + 1 < 2, 0.8, d)
        for a, b in zip(*(st.tensors() for st in states)):
            if a.is_floating_point():  # bits, a NaN equal to a NaN
                assert torch.equal(torch.isnan(a), torch.isnan(b))
                a, b = (torch.nan_to_num(t).view(torch.int64) for t in (a, b))
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["x", "eps", "n_steps", "accepted"])
def test_nuts_state_rebinding_a_tensor_drops_k6_pointers(name):
    """K6 packs the state's pointers once; rebinding one of its tensors
    (not an in-place update) makes the next launch check and repack."""
    from pint_tpu_torch.gw import hmc

    f64 = dict(dtype=torch.float64)
    st = hmc.NutsState(torch.zeros((2, 3), **f64), torch.zeros((2, 3), **f64),
                       torch.zeros(2, **f64), torch.ones(3, **f64), 0.1)
    st._k6_ptrs = "packed"
    st.it = 4
    getattr(st, name).zero_()
    assert st._k6_ptrs == "packed"
    setattr(st, name, getattr(st, name).clone())
    assert st._k6_ptrs is None


def test_run_nuts_injected_draws_match_jax(small_posteriors):
    """A 2-chain, 3-draw run with JAX's own draws (replayed from the key
    splits its transition makes): the same chain."""
    jpost, tpost = small_posteriors
    kw = dict(n_chains=2, num_warmup=2, num_samples=1, chunk=3,
              num_leapfrog=4, seed=0)
    rj = jrun_nuts(jpost, **kw)
    draws = replay_draws(tpost.ndim, 2, 3, 4, 0)
    rt = run_nuts(tpost, draws=draws, **kw)
    sc = tpost.scales
    for a, b in ((rt.samples, rj.samples),
                 (rt.warmup_samples, rj.warmup_samples)):
        assert np.max(np.abs((a - np.asarray(b)) / sc)) <= tol.HMC_PATH_SCALES
    assert np.all(np.abs(rt.lnprob / np.asarray(rj.lnprob) - 1)
                  <= tol.HMC_LNP_REL)
    assert np.all(np.abs(rt.step_size / np.asarray(rj.step_size) - 1)
                  <= tol.HMC_LNP_REL)
    x0 = tpost.initial_chains(2, seed=0)
    path = np.concatenate([x0[None], np.asarray(rj.warmup_samples),
                           np.asarray(rj.samples)])
    assert np.array_equal(rt.accepted, np.any(path[1:] != path[:-1],
                                              axis=-1))
    assert rt.divergences == rj.divergences
    assert abs(rt.accept_rate - rj.accept_rate) <= 1e-9


def _loud():
    """24 pulsars x 40 TOAs with 4-mode red noise and a GWB at 1e-13 over
    4 modes: the amplitude likelihood peaks (at -13.0 on the grid below,
    44 below it at -13.25), and the pairs' cross-correlations rule out
    the mode in which every pulsar's red noise takes the common power
    (with 4, 8, 12 or 16 pulsars at 1e-13, or 4 at 3e-13, chains still
    settle there on some seeds: medians 1.3 to 3.0 below the peak)."""
    pairs = make_fake_pta(24, 40, seed=5, extra_par=RED)
    add_gwb([t for _, t in pairs], [m for m, _ in pairs], 1e-13,
            rng=pta_injection_seed(5, 24), nmodes=4)
    return pairs


def test_posterior_peak_consistent_with_grid(small_posteriors):
    """tests/test_kron_hmc.py:389-409 on the port's own generator, at the
    reference's seed 3: the sampled amplitude's median lands within 1 of
    the grid peak, and the best sampled point is no worse than the
    grid's best by more than 1.

    The reference's 4-pulsar array has a likelihood flat in log10 A
    below ~-14.5, so there the median swings with the seed in both
    packages (ROADMAP queue 3 item 3); this array's likelihood has a
    peak.  Medians of log10 A on seeds 0-5 against the grid peak -13.0
    (2 chains, 80 + 120 draws, 6 leapfrog steps): JAX -13.86, -13.05,
    -13.04, -13.04, -13.03, -12.98; the port -13.25, -13.08, -13.09,
    -13.04, -13.0, -13.0."""
    tpost = GWBPosterior(CommonProcess(
        pta_case_from_arrays(pta_case_arrays(_loud())), nmodes=NMODES,
        device=CPU))
    amps = np.linspace(-15.5, -12.5, 13)
    lnl = tpost.crn.lnlike_grid(amps, [GWB_GAMMA])[:, 0]
    grid_peak = amps[int(np.argmax(lnl))]
    assert lnl.max() - lnl[0] > 100.0  # a peak, not a flat tail
    res = run_nuts(tpost, num_warmup=80, num_samples=120, n_chains=2,
                   chunk=50, num_leapfrog=6, seed=3)
    assert res.samples.shape == (120, 2, tpost.ndim)
    assert 0.05 < res.accept_rate <= 1.0
    assert abs(np.median(res.flat()[:, 0]) - grid_peak) < 1.0
    assert res.max_posterior()[1] >= lnl.max() - 1.0
    # the generator's draws are the run's: same seed, same chain
    _, spost = small_posteriors
    again = run_nuts(spost, num_warmup=2, num_samples=2, n_chains=2,
                     chunk=2, num_leapfrog=3, seed=3)
    gen = torch.Generator(device=CPU).manual_seed(3)
    same = run_nuts(spost, num_warmup=2, num_samples=2, n_chains=2,
                    chunk=2, num_leapfrog=3, seed=3, generator=gen)
    assert np.array_equal(again.samples, same.samples)


def test_diverged_chain_raises(small_posteriors):
    """Every draw outside the support: the guard verdict raises."""
    from pint_tpu_torch.fitter import FitDivergedError

    _, tpost = small_posteriors
    x0 = np.repeat(tpost.center()[None], 2, axis=0)
    x0[:, 0] = -30.0
    with pytest.raises(FitDivergedError, match="diverged"):
        run_nuts(tpost, x0=x0, num_warmup=0, num_samples=2, n_chains=2,
                 num_leapfrog=2, step_size0=1e-6)


def _flagged_array():
    """tests/test_kron_hmc.py's flagged 3-pulsar array: EFAC selects its
    TOAs, so it changes sigma."""
    pairs = []
    for i in range(3):
        par = (f"PSR FK{i:02d}\nRAJ {2 * i:02d}:00:00\nDECJ +{10 * i:02d}"
               f":00:00\nF0 {100.0 + 10 * i!r} 1\nF1 -1e-15 1\n"
               "PEPOCH 54500\nDM 10\nTZRMJD 54500\nTZRSITE @\n"
               "TZRFRQ 1400\nUNITS TDB\nEPHEM builtin\n" + RED
               + "EFAC -f fake 1.1 1\n")
        m = get_model(par)
        t = make_fake_toas_uniform(
            53000, 56000, 30, m, obs="@", error_us=1.0, add_noise=True,
            rng=np.random.default_rng(i), flags={"f": "fake"})
        pairs.append((m, t))
    return pairs


@pytest.mark.parametrize("name,match", [("EFAC1", "changes sigma"),
                                        ("F0", "only PLRedNoise")])
def test_unsupported_sampled_name_raises(name, match):
    tpairs = pta_case_from_arrays(pta_case_arrays(_flagged_array()))
    crn = CommonProcess(tpairs, nmodes=2, device=CPU)
    assert GWBPosterior(crn).ndim == 2 + 2 * 3
    with pytest.raises(NotImplementedError, match=match):
        GWBPosterior(crn, sample=("TNREDAMP", name))


def test_iterate_fixed_matches_reference():
    """n applications of the body with records stacked as the
    reference's scan ys; n <= 0 returns the carry untouched."""
    def rec(prev, new):
        return {"d": new[0] - prev[0], "v": (new[1] * 2.0,)}

    init = (np.arange(3.0), np.float64(0.5))
    ref, ref_trace = compile_cache.iterate_fixed(
        lambda c: (c[0] * 1.5 + 1.0, c[1] + c[0].sum()),
        tuple(jnp.asarray(a) for a in init), 4, scan=True, trace_of=rec)
    got, trace = iterate_fixed(
        lambda c: (c[0] * 1.5 + 1.0, c[1] + c[0].sum()),
        tuple(torch.as_tensor(a) for a in init), 4, trace_of=rec)
    np.testing.assert_array_equal(_np(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(_np(trace["d"]), np.asarray(ref_trace["d"]))
    np.testing.assert_array_equal(_np(trace["v"][0]),
                                  np.asarray(ref_trace["v"][0]))
    assert trace["d"].shape == (4, 3)
    x = torch.zeros(2)
    assert iterate_fixed(lambda c: c + 1, x, 0) is x
    out = iterate_fixed(lambda c: c + 1, x, 0, trace_of=rec)
    assert out[0] is x and out[1] is None
