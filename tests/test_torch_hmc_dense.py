"""The port's dense GWB posterior (``GWBPosterior`` over
``CommonProcess(kron=False)``) and K11b's plain version against pint_tpu
at small size, on the CPU.

Two arrays from fixed seeds (``pint_tpu.simulation``), carried across as
plain arrays (``tools/export_torch_pta_case.pta_case_arrays`` ->
``convert.pta_case_from_arrays``):

- ``small``: tests/test_kron_hmc.py:64's 4 pulsars x 40 TOAs with 4-mode
  red noise and a GWB over 4 modes;
- ``ecorr``: 3 pulsars of 20 epochs x 3 TOAs 0.3 s apart (inside
  ECORR's 1 s window) with EFAC, EQUAD and ECORR fixed, 8-mode red noise
  and a GWB over 4 modes.

Each goes through one JAX dense posterior, whose jitted, vmapped
value-and-gradient is compiled once (the ORF is in its data, so the
singular ORFs reuse it) at 4 theta (the center, two chain starts, a
point outside the prior), and through the port's dense and kron
posteriors (``device="cpu"``: the kernels' plain versions).
Tolerances (``pint_tpu_torch/tolerances.py``): lnprob ``GW_LNLIKE_REL``
and the gradient ``HMC_GRAD_REL`` of max|g| (the reference's kron ==
dense pin, tests/test_kron_hmc.py:341-355), central differences 1e-6
relative (tests/test_kron_hmc.py:356-373), plain K11b against
``torch.autograd`` of ``crn_capacity_plain`` ``GW_LNLIKE_REL`` under
Hellings-Downs; under the monopole and dipole, where the GW blocks'
kappa is ~1e12, lnprob ``GW_SINGULAR_REL`` and the gradient
``crn_capacity_limit`` of that kappa (the reference's own dense gradient
is as far from the kron one there, which the test shows); the dense
chain against the kron chain on the same injected draws
``HMC_PATH_SCALES`` / ``HMC_LNP_REL`` up to the first near tie decided
otherwise.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pint_tpu.gw import CommonProcess as JCommonProcess
from pint_tpu.gw import GWBPosterior as JGWBPosterior
from pint_tpu.models.builder import get_model
from pint_tpu.simulation import (add_gwb, make_fake_pta,
                                 make_fake_toas_fromMJDs, pta_injection_seed)
from pint_tpu_torch import tolerances as tol
from pint_tpu_torch.convert import pta_case_from_arrays
from pint_tpu_torch.gw.common import CommonProcess
from pint_tpu_torch.gw.hmc import GWBPosterior, run_nuts
from pint_tpu_torch.gw.orf import orf_matrix
from pint_tpu_torch.linalg import (crn_capacity, crn_capacity_bwd_plain,
                                   crn_capacity_plain, crn_gw_inverse_plain)
from tools.export_torch_hmc_case import replay_draws
from tools.export_torch_pta_case import pta_case_arrays

NMODES = 4
CPU = "cpu"


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


def _small():
    pairs = make_fake_pta(4, 40, seed=5,
                          extra_par="TNRedAmp -13.5\nTNRedGam 4.0\n"
                                    "TNRedC 4\n")
    add_gwb([t for _, t in pairs], [m for m, _ in pairs], 3e-14,
            rng=pta_injection_seed(5, 4), nmodes=NMODES)
    return pairs


def _ecorr():
    """3 pulsars x 20 epochs x 3 TOAs 0.3 s apart, EFAC/EQUAD/ECORR on
    every TOA (``-f fake``), 8-mode red noise, a GWB over 4 modes."""
    pairs = []
    for i in range(3):
        par = (f"PSR EC{i:02d}\nRAJ {4 * i:02d}:00:00\nDECJ "
               f"{20 * i - 20:+03d}:00:00\nF0 {100.0 + 10 * i!r} 1\n"
               "F1 -1e-15 1\nPEPOCH 54500\nDM 10\nTZRMJD 54500\n"
               "TZRSITE @\nTZRFRQ 1400\nUNITS TDB\nEPHEM builtin\n"
               "TNRedAmp -13.5\nTNRedGam 4.0\nTNRedC 8\n"
               "EFAC -f fake 1.1\nEQUAD -f fake 0.5\nECORR -f fake 0.8\n")
        m = get_model(par)
        epochs = np.linspace(53000.0, 56000.0, 20)
        mjds = (epochs[:, None]
                + np.arange(3)[None, :] * 0.3 / 86400.0).ravel()
        t = make_fake_toas_fromMJDs(mjds, m, add_noise=True,
                                    rng=np.random.default_rng(40 + i),
                                    flags={"f": "fake"})
        pairs.append((m, t))
    add_gwb([t for _, t in pairs], [m for m, _ in pairs], 5e-14,
            rng=pta_injection_seed(9, 3), nmodes=NMODES)
    return pairs


class Case:
    """One array through both packages: the JAX dense posterior's answers
    at ``theta``, the port's dense and kron posteriors."""

    def __init__(self, name):
        jpairs = {"small": _small, "ecorr": _ecorr}[name]()
        self.tpairs = tpairs = pta_case_from_arrays(pta_case_arrays(jpairs))
        self.dense = GWBPosterior(CommonProcess(
            tpairs, nmodes=NMODES, kron=False, device=CPU))
        self.kron = GWBPosterior(CommonProcess(tpairs, nmodes=NMODES,
                                               device=CPU))
        self.jpost = JGWBPosterior(JCommonProcess(jpairs, nmodes=NMODES,
                                                  kron=False))
        oob = self.dense.center()
        oob[0] = -30.0
        self.theta = np.concatenate([
            self.dense.center()[None],
            self.dense.initial_chains(2, seed=1, ball=1.0), oob[None]])
        self.jpost.crn.U_full  # built here: it is cached on first use
        self.jdata = self.jpost.data()
        #: the JAX posterior's value and gradient at (theta (n, ndim),
        #: its data), compiled once; the data carries the ORF
        self.jvg = jax.jit(jax.vmap(jax.value_and_grad(
            self.jpost.lnprob), in_axes=(0, None)))
        self.lnp, self.grad = (np.asarray(a) for a in self.jvg(
            jnp.asarray(self.theta), self.jdata))


@functools.lru_cache(maxsize=None)
def _case(name):
    return Case(name)


@pytest.fixture(scope="module", params=["small", "ecorr"])
def case(request):
    return _case(request.param)


@pytest.fixture(scope="module")
def small():
    return _case("small")


def _grad_rel(got, ref):
    return max(float(np.max(np.abs(g - r)) / np.max(np.abs(r)))
               for g, r in zip(got, ref))


def test_layout_and_dense_columns(case):
    """The dense posterior samples what the kron one and JAX's do, and
    its noise weights at the center are the dense path's own (each
    pulsar's build weights, concatenated)."""
    d, k = case.dense, case.kron
    assert d.param_names == k.param_names == case.jpost.param_names
    assert d.noise_params == k.noise_params
    assert np.array_equal(d.bounds, k.bounds)
    assert np.array_equal(d.scales, k.scales)
    d.value_and_grad(torch.as_tensor(case.theta[:1]))
    assert d.crn._kron_data is None  # the dense path builds no kron stacks
    phi = d.phi_noise_at(torch.as_tensor(d.center()))
    np.testing.assert_allclose(_np(d.crn.dense_noise(phi)),
                               _np(d.crn.dense.phi_noise), rtol=1e-14,
                               atol=0.0)
    if d.param_names[2].startswith("EC"):  # ECORR's epochs in the basis
        assert all(x.U.shape[1] == 39 for x in d.crn.data)


def test_lnprob_and_grad_match_jax_dense(case):
    lt, gt = (_np(a) for a in case.dense.value_and_grad(
        torch.as_tensor(case.theta)))
    fin = np.isfinite(case.lnp)
    assert np.all(np.abs(lt[fin] / case.lnp[fin] - 1)
                  <= tol.GW_LNLIKE_REL), lt / case.lnp - 1
    assert _grad_rel(gt[fin], case.grad[fin]) <= tol.HMC_GRAD_REL
    # outside the prior: -inf, and JAX's (zero) gradient
    assert np.all(lt[~fin] == -np.inf) and not np.all(fin)
    assert np.array_equal(gt[~fin], case.grad[~fin])


def test_dense_equals_kron(case):
    """The reference's own pin, on the port: the dense posterior and the
    kron posterior at the same theta."""
    th = torch.as_tensor(case.theta[:3])
    ld, gd = (_np(a) for a in case.dense.value_and_grad(th))
    lk, gk = (_np(a) for a in case.kron.value_and_grad(th))
    assert np.all(np.abs(ld / lk - 1) <= tol.GW_LNLIKE_REL), ld / lk - 1
    assert _grad_rel(gd, gk) <= tol.HMC_GRAD_REL


@pytest.mark.parametrize("orf_kind", ["monopole", "dipole"])
def test_dense_equals_kron_singular(small, orf_kind):
    """Under the rank-deficient ORFs the port's dense posterior against
    its kron one and JAX's dense one (the compiled function, the ORF
    swapped in its data): lnprob within ``GW_SINGULAR_REL`` (the
    reference's pin for them), the gradient within ``crn_capacity_limit``
    of the GW blocks' kappa, as JAX's dense gradient is of the kron one
    (both rest on block inverses whose ridge, 1e-12 of the diagonal, is
    stored to ~1e-4 of itself)."""
    kw = dict(nmodes=NMODES, orf=orf_kind, device=CPU)
    dense = GWBPosterior(CommonProcess(small.tpairs, kron=False, **kw))
    kron = GWBPosterior(CommonProcess(small.tpairs, **kw))
    th = torch.as_tensor(small.theta[:3])
    ld, gd = (_np(a) for a in dense.value_and_grad(th))
    lk, gk = (_np(a) for a in kron.value_and_grad(th))
    lj, gj = (np.asarray(a) for a in small.jvg(
        jnp.asarray(small.theta[:3]),
        dict(small.jdata, orf=jnp.asarray(dense.crn.orf))))
    for lnp in (lk, lj):
        assert np.all(np.abs(ld / lnp - 1) <= tol.GW_SINGULAR_REL), \
            ld / lnp - 1
    phi_gw = dense.crn._phi_gw(th[:, 0], th[:, 1])
    lim = tol.crn_capacity_limit(
        dense.crn.n_pulsars, tol.crn_block_kappa(dense.crn.orf, _np(phi_gw)))
    errs = [_grad_rel(gd, gk), _grad_rel(gd, gj), _grad_rel(gj, gk)]
    assert max(errs) <= lim, (errs, lim)


@pytest.mark.parametrize("which", ["gwb_log10_A", "gwb_gamma",
                                   "FAKE00:TNREDAMP"])
def test_grad_vs_central_differences(small, which):
    """The dense gradient within 1e-6 relative of central differences
    (h = 1e-5), as tests/test_kron_hmc.py:356-373 holds JAX's."""
    post = small.dense
    i = post.param_names.index(which)
    th = post.center()
    _, g = post.value_and_grad(torch.as_tensor(th[None]))
    g = float(g[0, i])
    h = 1e-5
    xs = np.repeat(th[None], 2, axis=0)
    xs[0, i] += h
    xs[1, i] -= h
    lp = _np(post.lnprob(torch.as_tensor(xs)))
    fd = (lp[0] - lp[1]) / (2 * h)
    assert abs(fd - g) / max(abs(g), 1e-8) < 1e-6, (which, fd, g)


def _k11b_case(post, orf_kind):
    """The dense path's gram at two chains' noise weights (a row a
    point) and two GW points, under ``orf_kind``."""
    crn = post.crn
    th = post.initial_chains(2, seed=3, ball=1.0)
    phi = post.phi_noise_at(torch.as_tensor(th))
    pn = crn.dense_noise(phi)
    pg = crn._phi_gw(torch.as_tensor(th[:, 0]), torch.as_tensor(th[:, 1]))
    orf = torch.as_tensor(orf_matrix(crn.pos, orf_kind))
    return crn.dense.gram, pn, orf, pg


@pytest.mark.parametrize("orf_kind", ["hd", "monopole"])
def test_plain_k11b_against_autograd(small, orf_kind):
    """Plain K11b against ``torch.autograd`` through
    ``crn_capacity_plain`` (the dense prior's Cholesky inverse and
    logdet), for seeded random cotangents: per-point weights, weights
    shared by every point (their cotangents summed), and through the
    autograd.Function that carries K11 / K11b."""
    gram, pn, orf, pg = _k11b_case(small.dense, orf_kind)
    # under the monopole both rest on inverses of blocks of kappa ~4e12
    # (the plain K11b's by blocks, autograd's through the dense prior's
    # Cholesky)
    lim = tol.GW_LNLIKE_REL if orf_kind == "hd" else tol.crn_capacity_limit(
        orf.shape[0], tol.crn_block_kappa(_np(orf), _np(pg)))
    rng = np.random.default_rng(17)
    k = gram.shape[0]
    gS = torch.as_tensor(rng.standard_normal((2, k, k)))
    gld = torch.as_tensor(rng.standard_normal(2))
    M = crn_gw_inverse_plain(orf, pg)
    for noise in (pn, pn[0]):
        a_n, a_g = (t.clone().requires_grad_(True) for t in (noise, pg))
        want = torch.autograd.grad(crn_capacity_plain(gram, a_n, orf, a_g),
                                   (a_n, a_g), (gS, gld))
        got_n, got_g = crn_capacity_bwd_plain(gS, gld, noise, pg, M)
        if noise.dim() == 1:
            got_n = got_n.sum(dim=0)
        assert tol.vector_rel(_np(got_n), _np(want[0])) <= lim, orf_kind
        assert tol.vector_rel(_np(got_g), _np(want[1])) <= lim, orf_kind
        b_n, b_g = (t.clone().requires_grad_(True) for t in (noise, pg))
        fn = torch.autograd.grad(crn_capacity(gram, b_n, orf, b_g),
                                 (b_n, b_g), (gS, gld))
        assert torch.equal(fn[0], got_n) and torch.equal(fn[1], got_g)


def test_crn_capacity_gradcheck_and_gram_raises():
    """torch.autograd.gradcheck of ``crn_capacity`` (its fast mode: one
    random projection of the Jacobian) on a random 2-pulsar prior (K = 8)
    at two points; a gram that requires grad raises."""
    rng = np.random.default_rng(2)
    p, m2, nn = 2, 2, 2
    pos = rng.standard_normal((p, 3))
    pos /= np.linalg.norm(pos, axis=1)[:, None]
    k = p * nn + p * m2
    a = rng.standard_normal((2 * k, k))
    gram = torch.as_tensor(a.T @ a)
    orf = torch.as_tensor(orf_matrix(pos, "hd"))
    pn = torch.as_tensor(10.0 ** rng.uniform(-1, 1, (2, p * nn)))
    pg = torch.as_tensor(10.0 ** rng.uniform(-1, 0, (2, m2)))
    assert torch.autograd.gradcheck(
        lambda x, y: crn_capacity(gram, x, orf, y),
        (pn.requires_grad_(True), pg.requires_grad_(True)), eps=1e-6,
        atol=1e-7, rtol=1e-6, fast_mode=True)
    with pytest.raises(ValueError, match="requires grad"):
        crn_capacity(gram.clone().requires_grad_(True), pn, orf, pg)


def test_sigma_changing_name_raises_on_dense():
    """EFAC changes sigma: the dense posterior raises as the kron one
    does, naming the queue item that ports it."""
    crn = _case("ecorr").dense.crn
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        GWBPosterior(crn, sample=("TNREDAMP", "EFAC1"))


def test_run_nuts_dense_matches_kron_on_injected_draws(small):
    """A 2-chain, 3-draw run (a warmup draw, then two sampling draws)
    with the same injected draws on the dense and the kron posterior:
    the same chain up to the first near tie decided otherwise
    (|log u - log accept| below the two lnps' limits), or all of it."""
    kw = dict(n_chains=2, num_warmup=1, num_samples=2, chunk=3,
              num_leapfrog=3, seed=0)
    draws = replay_draws(small.dense.ndim, 2, 3, 3, 0)
    rd = run_nuts(small.dense, draws=draws, **kw)
    rk = run_nuts(small.kron, draws=draws, **kw)
    path_d = np.concatenate([rd.warmup_samples, rd.samples])
    path_k = np.concatenate([rk.warmup_samples, rk.samples])
    margin = np.abs(np.log(draws[2]) - np.log(rk.accept_prob))
    tie = margin < 2.0 * tol.HMC_LNP_REL * np.max(np.abs(rk.lnprob))
    parted = np.any((rd.accepted != rk.accepted) & tie, axis=1)
    n = int(np.argmax(parted)) if parted.any() else len(parted)
    assert np.array_equal(rd.accepted[:n], rk.accepted[:n])
    assert np.max(np.abs((path_d[:n] - path_k[:n]) / small.dense.scales),
                  initial=0.0) <= tol.HMC_PATH_SCALES
    ns = max(0, n - kw["num_warmup"])  # sampling draws before the parting
    assert np.all(np.abs(rd.lnprob[:ns] / rk.lnprob[:ns] - 1)
                  <= tol.HMC_LNP_REL)
    assert n > 0
