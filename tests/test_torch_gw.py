"""The port's GW path (``pint_tpu_torch.gw``) against pint_tpu at small
size, on the CPU.

One ragged array, made with numpy from fixed seeds by
``pint_tpu.simulation``: three pulsars of 60 TOAs and three of 45 (two
``make_fake_pta`` calls with different ``name_prefix``), each with
8-mode power-law red noise, plus one 50-TOA pulsar without red noise
(a different basis width nb), a GWB injected over 4 common modes.  It
goes through pint_tpu and, carried across as plain arrays
(``tools/export_torch_pta_case.pta_case_arrays`` ->
``convert.pta_case_from_arrays``), through the port with
``device="cpu"`` (the kernels' plain versions).  Tolerances
(``pint_tpu_torch/tolerances.py``):

- ORF matrix, pulsar positions: 1e-12 relative;
- per-pulsar data r, sigma, U (incl. the jacfwd timing-design columns),
  phi, F: 1e-12 relative to each array's (column's) largest entry;
- the ragged weighted grams (K3's plain version): within 1e-12 of the
  sum of the absolute values of each entry's terms;
- ``woodbury_solve`` and the whitened z, M: 1e-9 (tests/test_gw.py's
  pin); ``kron_chi2_logdet`` 1e-10 (tests/test_kron_hmc.py's kron ==
  dense pin);
- ``lnlike`` / ``lnlike_grid`` 1e-10; the optimal statistic and
  ``noise_marginalized`` 1e-9 (vectors relative to their largest
  element, ``tolerances.vector_rel``).
"""

import numpy as np
import pytest
import torch

from pint_tpu import linalg as jlinalg
from pint_tpu.gw import CommonProcess as JCommonProcess
from pint_tpu.gw import OptimalStatistic as JOptimalStatistic
from pint_tpu.gw import orf as jorf
from pint_tpu.gw.os import _zm_one
from pint_tpu.simulation import add_gwb, make_fake_pta
from pint_tpu_torch import tolerances as tol
from pint_tpu_torch.convert import load_pta_case, pta_case_from_arrays
from pint_tpu_torch.fitter import FitDivergedError
from pint_tpu_torch.gw import common as tgw_common
from pint_tpu_torch.gw import orf as torf
from pint_tpu_torch.gw import os as gos
from pint_tpu_torch.gw.common import (PAD_SIGMA_S, CommonProcess,
                                      build_pulsar_data)
from pint_tpu_torch.gw.os import OptimalStatistic, os_pairs_plain
from pint_tpu_torch.linalg import (KronPhi, kron_chi2_logdet,
                                   kron_gram_plain, kron_gram_precompute,
                                   kron_phi_dense, kron_pulsar_terms,
                                   ragged_stack, woodbury_solve)
from tools.export_torch_pta_case import noise_draws, pta_case_arrays

# one intra-op thread: the tests run at small sizes, and pytest-xdist's
# workers share the machine's cores (torch's default of one thread per
# core in every worker oversubscribes them several times over)
torch.set_num_threads(1)

NMODES = 4
RED = "TNRedAmp -13.5\nTNRedGam 4.0\nTNRedC 8\n"
CPU = "cpu"


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


@pytest.fixture(scope="module")
def jpairs():
    kw = dict(duration_days=3000.0)
    pairs = (make_fake_pta(3, 60, seed=1, extra_par=RED, name_prefix="A",
                           **kw)
             + make_fake_pta(4, 45, seed=2, extra_par=RED,
                             name_prefix="B", **kw)[1:]
             + make_fake_pta(5, 50, seed=3, name_prefix="C", **kw)[3:4])
    add_gwb([t for _, t in pairs], [m for m, _ in pairs], 5e-14, rng=11,
            nmodes=NMODES)
    return pairs


@pytest.fixture(scope="module")
def tpairs(jpairs):
    return pta_case_from_arrays(pta_case_arrays(jpairs))


@pytest.fixture(scope="module")
def jos(jpairs):
    return JOptimalStatistic(jpairs, nmodes=NMODES)


@pytest.fixture(scope="module")
def tos(tpairs):
    return OptimalStatistic(tpairs, nmodes=NMODES, device=CPU)


def _padded(data, m2):
    """The reference's padded per-pulsar stacks of ``data``."""
    p = len(data)
    n_max = max(len(d.r) for d in data)
    nb_max = max(d.U.shape[1] for d in data)
    r = np.zeros((p, n_max))
    sig = np.full((p, n_max), PAD_SIGMA_S)
    valid = np.zeros((p, n_max), bool)
    U = np.zeros((p, n_max, nb_max))
    F = np.zeros((p, n_max, m2))
    phi = np.zeros((p, nb_max))
    for a, d in enumerate(data):
        n, nb = d.U.shape
        r[a, :n], sig[a, :n], valid[a, :n] = d.r, d.sigma, True
        U[a, :n, :nb], F[a, :n], phi[a, :nb] = d.U, d.F, d.phi
    return r, sig, U, F, valid, phi


def _stack(data):
    return ragged_stack([d.r for d in data], [d.sigma for d in data],
                        [d.U for d in data], [d.F for d in data], CPU)


def test_array_is_ragged(tos):
    n = [len(d.r) for d in tos.data]
    nb = [d.U.shape[1] for d in tos.data]
    assert n == [60] * 3 + [45] * 3 + [50]
    assert nb == [16 + 3] * 6 + [3]


def test_orf_matrix_and_positions(jpairs, tpairs):
    pos_j = np.asarray(jorf.pulsar_positions([m for m, _ in jpairs]))
    pos_t = torf.pulsar_positions([m for m, _, _ in tpairs])
    assert tol.vector_rel(pos_t, pos_j) <= 1e-12
    for kind in ("hd", "monopole", "dipole"):
        g_t = torf.orf_matrix(pos_t, kind)
        g_j = np.asarray(jorf.orf_matrix(pos_j, kind))
        np.testing.assert_allclose(g_t, g_j, rtol=1e-12, atol=1e-15,
                                   err_msg=kind)
        assert np.array_equal(g_t, g_t.T)
    zeta = np.linspace(0.0, np.pi, 50)
    np.testing.assert_allclose(torf.hellings_downs(zeta),
                               np.asarray(jorf.hellings_downs(zeta)),
                               rtol=1e-12)
    for a, b in zip(torf.pair_indices(7), jorf.pair_indices(7)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="unknown ORF"):
        torf.orf_matrix(pos_t, "quadrupole")


def test_build_pulsar_data(jos, tos):
    assert tos.freqs.tolist() == np.asarray(jos.freqs).tolist()
    assert tos.df == jos.df
    for dj, dt in zip(jos.data, tos.data):
        assert dt.name == dj.name
        for k in ("r", "sigma", "phi", "F"):
            assert tol.vector_rel(getattr(dt, k), getattr(dj, k)) \
                <= 1e-12, (dj.name, k)
        assert dt.U.shape == dj.U.shape
        for c in range(dj.U.shape[1]):
            assert tol.vector_rel(dt.U[:, c], dj.U[:, c]) <= 1e-12, \
                (dj.name, c)


def test_build_options(jpairs, tpairs):
    """No timing marginalization and an explicit span, as the reference
    builds them."""
    from pint_tpu.gw.common import build_pulsar_data as jbuild

    T = 3.5e8
    dj, _, fj, dfj, _ = jbuild(jpairs, nmodes=3, tspan_s=T,
                               marginalize_timing=False)
    dt, _, ft, dft, _ = build_pulsar_data(tpairs, nmodes=3, tspan_s=T,
                                          marginalize_timing=False,
                                          device=CPU)
    assert np.array_equal(ft, np.asarray(fj)) and dft == dfj == 1.0 / T
    for a, b in zip(dt, dj):
        assert a.U.shape == b.U.shape == (len(b.r), b.U.shape[1])
        assert b.U.shape[1] in (17, 1)  # red noise + offset, or offset
        for k in ("U", "phi", "F"):
            assert tol.vector_rel(getattr(a, k), getattr(b, k)) <= 1e-12


def test_kron_gram_plain_vs_jax(tos):
    data = tos.data
    m2 = 2 * NMODES
    r, sig, U, F, valid, _ = _padded(data, m2)
    ref = jlinalg.kron_gram_precompute(r, sig, U, F, valid=valid)
    st = _stack(data)
    got = kron_gram_precompute(st)
    # per-entry scale: the same sums over |T|
    abs_st = ragged_stack([np.abs(d.r) for d in data],
                          [d.sigma for d in data],
                          [np.abs(d.U) for d in data],
                          [np.abs(d.F) for d in data], CPU)
    scale = kron_gram_precompute(abs_st)
    for k in ("g_uu", "g_uf", "g_ff", "b_u", "b_f", "rr", "ld_white"):
        g, rf, s = _np(getattr(got, k)), np.asarray(getattr(ref, k)), \
            _np(getattr(scale, k))
        if k == "ld_white":
            s = np.abs(rf)
        assert np.all(np.abs(g - rf) <= 1e-12 * s), k
    # pad entries are exact zeros
    gram, _ = kron_gram_plain(st)
    nb = st.nb_host[-1]
    assert torch.all(gram[-1, nb:st.nb_max, :] == 0)


@pytest.mark.parametrize("n", [0, 1, 37, 127, 128, 129, 500, 1279, 1281,
                               10_000, 10_001, 123_457])
def test_k3_row_splits_cover_every_row_once(n):
    """K3's split rule: ascending, contiguous, every row in exactly one
    split; at most K3_MAX_SPLITS splits and none longer than needed."""
    from pint_tpu_torch.linalg import (K3_MAX_SPLITS, K3_SPLIT_ROWS,
                                       k3_row_splits)

    sp = k3_row_splits(n)
    assert sp[0][0] == 0 and sp[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(sp, sp[1:]))
    assert all(a <= b for a, b in sp)
    rows = np.concatenate([np.arange(a, b) for a, b in sp])
    assert np.array_equal(rows, np.arange(n))
    assert 1 <= len(sp) <= K3_MAX_SPLITS
    if len(sp) < K3_MAX_SPLITS:
        assert max(b - a for a, b in sp) <= K3_SPLIT_ROWS


def test_kron_chi2_logdet_vs_jax(tos):
    m2 = 2 * NMODES
    r, sig, U, F, valid, phi = _padded(tos.data, m2)
    st = _stack(tos.data)
    for seed, kind in ((0, "hd"), (1, "hd"), (2, "dipole")):
        phi_gw = 10.0 ** np.random.default_rng(seed).uniform(-16, -13, m2)
        orf = torf.orf_matrix(tos.pos, kind)
        c_j, ld_j = jlinalg.kron_chi2_logdet(
            r, sig, U, F, jlinalg.KronPhi(orf=orf, phi_gw=phi_gw,
                                          phi_noise=phi), valid=valid)
        kp = KronPhi(orf=torch.as_tensor(orf), phi_gw=torch.as_tensor(
            phi_gw), phi_noise=torch.as_tensor(phi))
        c_t, ld_t = kron_chi2_logdet(st, kp)
        assert abs(float(c_t) / float(c_j) - 1) <= tol.GW_LNLIKE_REL, seed
        assert abs(float(ld_t) / float(ld_j) - 1) <= tol.GW_LNLIKE_REL, \
            seed
        dense_j = np.asarray(jlinalg.kron_phi_dense(jlinalg.KronPhi(
            orf=orf, phi_gw=phi_gw, phi_noise=phi)))
        assert np.array_equal(_np(kron_phi_dense(kp)), dense_j)


def test_woodbury_solve_and_whitening(jos, tos):
    m2 = 2 * NMODES
    _, z, M, _ = kron_pulsar_terms(tos.kron_data.gram,
                                   tos.kron_data.phi_noise)
    for a, d in enumerate(tos.data):
        args = (d.sigma, d.U, d.phi)
        cf_j = np.asarray(jlinalg.woodbury_solve(*args, d.F))
        cf_t = woodbury_solve(*(torch.as_tensor(x) for x in args),
                              torch.as_tensor(d.F))
        assert tol.vector_rel(_np(cf_t), cf_j) <= tol.GW_OS_REL, a
        z_j, M_j = _zm_one(d.r, d.sigma, d.U, d.phi, d.F)
        assert tol.vector_rel(_np(z[a]), z_j) <= tol.GW_OS_REL, a
        assert tol.vector_rel(_np(M[a]), M_j) <= tol.GW_OS_REL, a
    assert z.shape == (len(tos.data), m2)


def test_os_pairs_plain_order():
    """The plain pair stage reads M_b transposed (M is not assumed
    symmetric) and matches a per-pair loop."""
    rng = np.random.default_rng(5)
    z = torch.as_tensor(rng.standard_normal((5, 6)))
    M = torch.as_tensor(rng.standard_normal((5, 6, 6)))
    ph = torch.as_tensor(rng.uniform(0.1, 1.0, 6))
    ii, jj = (torch.as_tensor(x) for x in torf.pair_indices(5))
    num, den = os_pairs_plain(z, M, ph, ii, jj)
    for p, (a, b) in enumerate(zip(ii.tolist(), jj.tolist())):
        want = torch.einsum("i,ij,j,ji->", ph, M[a], ph, M[b])
        assert abs(float(den[p] - want)) <= 1e-13 * float(
            torch.einsum("i,ij,j,ji->", ph, M[a].abs(), ph, M[b].abs()))
        assert torch.allclose(num[p], z[a] @ (ph * z[b]), rtol=1e-14)


@pytest.mark.parametrize("p", [2, 3, 6, 17])
def test_os_pairs_take_every_pair_in_pair_indices_order(p):
    """The dispatcher's pairs are every a < b in the row-major upper
    triangle, the order of orf.pair_indices (and of K4's closed-form pair
    index), bit for bit the plain version over those indices."""
    ii, jj = torf.pair_indices(p)
    ti, tj = torch.triu_indices(p, p, 1)
    assert np.array_equal(ti.numpy(), ii) and np.array_equal(tj.numpy(), jj)
    a, b = np.nonzero(np.triu(np.ones((p, p)), 1))
    k = a * p - a * (a + 1) // 2 + b - a - 1
    assert np.array_equal(k, np.arange(len(ii)))
    assert np.array_equal(ii[k], a) and np.array_equal(jj[k], b)
    rng = np.random.default_rng(p)
    z = torch.as_tensor(rng.standard_normal((p, 4)))
    M = torch.as_tensor(rng.standard_normal((p, 4, 4)))
    ph = torch.as_tensor(rng.uniform(0.1, 1.0, 4))
    got = gos.os_pairs(z, M, ph)
    want = os_pairs_plain(z, M, ph, torch.as_tensor(ii), torch.as_tensor(jj))
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_optimal_statistic(jos, tos):
    rj, rt = jos.compute(), tos.compute()
    for k in ("ahat2", "snr", "sigma_ahat2"):
        assert abs(getattr(rt, k) / getattr(rj, k) - 1) <= tol.GW_OS_REL, k
    for k in ("rho", "sig"):
        assert tol.vector_rel(getattr(rt, k), getattr(rj, k)) \
            <= tol.GW_OS_REL, k
    assert np.array_equal(rt.pairs, np.asarray(rj.pairs))
    np.testing.assert_allclose(rt.orf_vals, rj.orf_vals, rtol=1e-12)


def test_noise_marginalized(jos, tos):
    amps, gams = noise_draws(6, tos.n_pulsars, seed=3)
    for a_in, g_in in ((amps, gams), (amps[:, 0], gams[:, 0])):
        got = tos.noise_marginalized(a_in, g_in)
        ref = jos.noise_marginalized(a_in, g_in)
        for g, r in zip(got, ref):
            assert tol.vector_rel(g, np.asarray(r)) <= tol.GW_OS_REL


@pytest.fixture(scope="module")
def crn_pair(jos, tos):
    jcrn = JCommonProcess(nmodes=NMODES, orf="hd", kron=True,
                          _prebuilt=(jos.data, jos.pos, jos.freqs, jos.df))
    return jcrn, tos.common_process()


def test_lnlike_and_grid(crn_pair, monkeypatch):
    jcrn, tcrn = crn_pair
    for la, g in ((-14.0, 13 / 3), (-13.2, 3.0), (-15.5, 5.5)):
        assert abs(tcrn.lnlike(la, g) / jcrn.lnlike(la, g) - 1) \
            <= tol.GW_LNLIKE_REL, (la, g)
    amps, gams = np.linspace(-15.0, -13.5, 3), np.linspace(2.0, 6.0, 4)
    ref = jcrn.lnlike_grid(amps, gams)
    got = tcrn.lnlike_grid(amps, gams)
    assert got.shape == (3, 4)
    assert np.max(np.abs(got / ref - 1)) <= tol.GW_LNLIKE_REL
    # batched in chunks of one point: the same surface
    monkeypatch.setattr(tgw_common, "GRID_MEM_BYTES", 1)
    assert tcrn.grid_chunk() == 1
    assert np.array_equal(tcrn.lnlike_grid(amps, gams), got)


def test_common_process_built_alone(tpairs, crn_pair):
    """A CommonProcess built from pairs equals the one sharing the OS
    build, and its dense twin (kron=False) equals it (the reference's
    kron == dense pin)."""
    _, shared = crn_pair
    alone = CommonProcess(tpairs, nmodes=NMODES, device=CPU)
    assert alone.lnlike(-14.0, 4.0) == shared.lnlike(-14.0, 4.0)
    dense = CommonProcess(tpairs, nmodes=NMODES, kron=False, device=CPU)
    assert abs(dense.lnlike(-14.0, 4.0) / alone.lnlike(-14.0, 4.0) - 1) \
        <= tol.GW_LNLIKE_REL


def test_non_finite_is_reported(crn_pair):
    _, tcrn = crn_pair
    with pytest.raises(FitDivergedError):
        tcrn.lnlike(np.nan, 4.0)
    assert np.isnan(tcrn.lnlike(np.nan, 4.0, check=False))
    with pytest.warns(UserWarning, match="1/2 non-finite"):
        surf = tcrn.lnlike_grid([-14.0], [4.0, np.nan])
    assert np.isfinite(surf[0, 0]) and np.isnan(surf[0, 1])


def test_build_needs_two_pulsars(tpairs):
    with pytest.raises(ValueError, match=">= 2 pulsars"):
        build_pulsar_data(tpairs[:1], device=CPU)


def test_committed_pta_case():
    arrays, pairs = load_pta_case()
    assert len(pairs) == 68
    assert all(len(t) == 500 for _, t, _ in pairs)
    assert int(arrays["ref_nmodes"]) == 14
    assert arrays["ref_os_rho"].shape == (68 * 67 // 2,)
    assert arrays["ref_draws_log10_amp"].shape == (32, 68)
    assert arrays["ref_grid_lnlike"].shape == (16, 16)
    assert np.all(np.isfinite(arrays["ref_grid_lnlike"]))
    names = [m.name for m, _, _ in pairs]
    assert names == [f"FAKE{i:02d}" for i in range(68)]
