"""Kernels K1-K12 (with K11b and K12b) on the card against their plain PyTorch
versions, and the double-double arithmetic on CUDA tensors against the
same calls on CPU tensors.

These tests need an NVIDIA GPU with nvcc (Hopper, sm_90a) and skip
without one.  They import nothing of JAX, so they also run on a machine
without it; tests/conftest.py imports JAX, so there run them with::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    return torch.device("cuda")


def test_k1_bit_identical_to_plain(card):
    from pint_tpu_torch import fixedpoint as fp

    rng = np.random.default_rng(0)
    f0 = torch.tensor(rng.uniform(1.0, 2048.0, 100_000))
    tmax = np.minimum(2.0**62, 0.999 * 2.0**43 / f0.numpy() * 2.0**32)
    t = torch.tensor(np.round(rng.uniform(-1, 1, f0.numel()) * tmax)
                     .astype(np.int64))
    n_ref, frac_ref = fp.phase_f0_t_plain(f0, t)
    n, frac = fp.phase_f0_t_cuda(f0.to(card), t.to(card))
    assert torch.equal(n.cpu(), n_ref)
    assert torch.equal(frac.cpu().view(torch.int64),
                       frac_ref.view(torch.int64))
    # a scalar F0 through the custom op, as the fit calls it
    n1, frac1 = fp.phase_f0_t(f0[0].to(card), t.to(card))
    n1_ref, frac1_ref = fp.phase_f0_t_plain(f0[0], t)
    assert torch.equal(n1.cpu(), n1_ref)
    assert torch.equal(frac1.cpu().view(torch.int64),
                       frac1_ref.view(torch.int64))


@pytest.mark.parametrize("m", [1, 10, 61])
def test_k2_bit_identical_and_deterministic(card, m):
    from pint_tpu_torch import linalg as tl

    rng = np.random.default_rng(m)
    seg = rng.integers(0, 401, 10_000)
    perm, offsets = (torch.tensor(a) for a in tl.epoch_csr(seg, 400))
    x = torch.tensor(rng.standard_normal((10_000, m)) * 1e6)
    ref = tl.segment_sum_plain(x, perm, offsets)
    a = tl.segment_sum_cuda(x.to(card), perm.to(card), offsets.to(card))
    b = tl.segment_sum_cuda(x.to(card), perm.to(card), offsets.to(card))
    assert torch.equal(a.cpu().view(torch.int64), ref.view(torch.int64))
    assert torch.equal(a.view(torch.int64), b.view(torch.int64))


def test_fit_on_card_counts_launches(card):
    from pint_tpu_torch.convert import load_case
    from pint_tpu_torch.fitter import GLSFitter
    from pint_tpu_torch.fixedpoint import K1
    from pint_tpu_torch.linalg import K2

    arrays, model, toas, tzr = load_case()
    K1.launches = K2.launches = 0
    GLSFitter(toas, model, tzr, device=card).fit_toas(maxiter=3)
    assert K1.launches > 0 and K2.launches > 0
    free = [str(p) for p in arrays["free_params"]]
    d = np.array([model.values[k] for k in free]) \
        - arrays["ref_fitted_values"]
    assert np.max(np.abs(d) / arrays["ref_uncertainties"]) < 1e-6


def _stack(card, seed, n_rows, nbs, m2):
    from pint_tpu_torch.linalg import ragged_stack

    rng = np.random.default_rng(seed)
    rs = [rng.standard_normal(n) * 1e-6 for n in n_rows]
    sig = [1e-6 * (0.5 + rng.random(n)) for n in n_rows]
    Us = [rng.standard_normal((n, nb)) for n, nb in zip(n_rows, nbs)]
    Fs = [rng.standard_normal((n, m2)) for n in n_rows]
    return ragged_stack(rs, sig, Us, Fs, card)


def test_k3_against_plain_and_deterministic(card):
    import dataclasses

    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch import linalg as tl

    # ragged rows and widths, a pulsar narrower than a tile, one wider;
    # then the split edges: fewer rows than one split (100, 1), row
    # counts that are no multiple of the split or of the 32-row chunk
    # (1000, 129, 10_001 past the 11-split cap), widths that are no
    # multiple of 8 (3 + 28 + 1 = 32 is one; 70 + 28 + 1, 29 + 28 + 1)
    # and a gram wider than one block's 48 blocks of 16 x 8 (100 + 28 + 1)
    for seed, rows, nbs in ((0, [500, 37, 1200, 64], [63, 3, 40, 70]),
                            (1, [100, 1000, 10_001, 129, 1],
                             [3, 70, 63, 29, 100])):
        st = _stack(card, seed, rows, nbs, 28)
        assert [len(tl.k3_row_splits(n)) for n in rows[:3]] == \
            ([3, 1, 7] if seed == 0 else [1, 6, 11])
        g1, l1 = tl.kron_gram_cuda(st)
        g2, l2 = tl.kron_gram_cuda(st)
        gp, lp = tl.kron_gram_plain(st)
        ga, _ = tl.kron_gram_plain(dataclasses.replace(st, t=st.t.abs()))
        assert torch.equal(g1.view(torch.int64), g2.view(torch.int64))
        assert torch.equal(l1.view(torch.int64), l2.view(torch.int64))
        assert torch.all(torch.abs(g1 - gp) <= tol.KERNEL_SUM_REL * ga)
        assert torch.allclose(l1, lp, rtol=1e-13, atol=0)
        assert torch.equal(g1, g1.transpose(-1, -2))
        assert torch.all(g1[gp == 0] == 0)  # the pad is exact zeros
    # the dispatcher launches K3 for CUDA tensors
    n0 = tl.K3.launches
    tl.kron_gram_precompute(st)
    assert tl.K3.launches == n0 + 1


@pytest.mark.parametrize("p,m2", [(2, 28), (3, 28), (17, 28), (68, 28),
                                  (68, 27), (33, 5), (9, 1)])
def test_k4_against_plain_and_deterministic(card, p, m2):
    """K4 at the OS's shapes (68 pulsars, m2 = 28), at the fewest
    pulsars, at counts that fill no 16 x 8 output tile (2, 3, 9, 17, 33)
    and at odd m2; within 1e-13 of each pair's sum of |terms| of the
    plain version over pair_indices, bit-identical run to run; the
    dispatcher launches it once."""
    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.gw import os as gos
    from pint_tpu_torch.gw.orf import pair_indices

    rng = np.random.default_rng(p * 100 + m2)
    z = torch.tensor(rng.standard_normal((p, m2)), device=card)
    M = torch.tensor(rng.standard_normal((p, m2, m2)), device=card)
    ph = torch.tensor(rng.uniform(0.0, 1.0, m2), device=card)
    ii, jj = (torch.tensor(x, device=card) for x in pair_indices(p))
    n1, d1 = gos.os_pairs_cuda(z, M, ph)
    n2, d2 = gos.os_pairs_cuda(z, M, ph)
    npl, dpl = gos.os_pairs_plain(z, M, ph, ii, jj)
    na, da = gos.os_pairs_plain(z.abs(), M.abs(), ph, ii, jj)
    assert n1.shape == d1.shape == ii.shape
    assert torch.equal(n1.view(torch.int64), n2.view(torch.int64))
    assert torch.equal(d1.view(torch.int64), d2.view(torch.int64))
    assert torch.all(torch.abs(n1 - npl) <= tol.KERNEL_SUM_REL * na)
    assert torch.all(torch.abs(d1 - dpl) <= tol.KERNEL_SUM_REL * da)
    n0 = gos.K4.launches
    n3, d3 = gos.os_pairs(z, M, ph)
    assert gos.K4.launches == n0 + 1
    assert torch.equal(n3, n1) and torch.equal(d3, d1)


def test_gw_path_on_card_counts_launches(card):
    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.convert import load_pta_case
    from pint_tpu_torch.gw.os import K4, OptimalStatistic
    from pint_tpu_torch.linalg import K3

    arrays, pairs = load_pta_case()
    K3.launches = K4.launches = 0
    ost = OptimalStatistic(pairs[:12], nmodes=14, device=card)
    res = ost.compute()
    assert K3.launches == 1 and K4.launches == 1
    cpu = OptimalStatistic(pairs[:12], nmodes=14, device="cpu").compute()
    assert abs(res.ahat2 / cpu.ahat2 - 1) <= tol.GW_OS_REL
    assert tol.vector_rel(res.rho, cpu.rho) <= tol.GW_OS_REL


def _grams(card, seed, p, nb, m2, n=200):
    from pint_tpu_torch.linalg import KronGram

    rng = np.random.default_rng(seed)
    t = rng.standard_normal((p, n, nb + m2 + 1))
    w = rng.uniform(0.5, 2.0, (p, n)) * 1e12
    g = np.matmul((t * w[..., None]).transpose(0, 2, 1), t)
    u, f = slice(0, nb), slice(nb, nb + m2)
    return KronGram(*(torch.tensor(a.copy(), device=card) for a in (
        g[:, u, u], g[:, u, f], g[:, f, f], g[:, u, -1], g[:, f, -1],
        g[:, -1, -1], rng.standard_normal(p))))


@pytest.mark.parametrize("nb", [63, 100, 29, 13, 1, 7, 9, 15, 17, 65,
                                144])
def test_k5_k5b_against_plain_and_deterministic(card, nb):
    """K5/K5b at the case's width (K5: 53 kB of shared memory), at a
    wider pulsar (120 kB, the dynamic limit raised), at widths that are
    no multiple of the 8-column panel or tile (8k +- 1 among them) and
    below 3 panels (13: the block inverses get their own area), at one
    column, and at the widest pulsar both narrow forms take at m2 = 28
    (144); a zero (padded) weight pins its column and gets no gradient;
    M_a is exactly symmetric."""
    from pint_tpu_torch import linalg as tl
    from pint_tpu_torch import tolerances as tol

    m2, p, c = 28, 5, 3
    pre = _grams(card, nb, p, nb, m2)
    rng = np.random.default_rng(1)
    phi_np = 10.0 ** rng.uniform(-16, -12, (c, p, nb))
    phi_np[:, 0, -3:] = 0.0
    phi = torch.tensor(phi_np, device=card)
    a = tl.kron_pulsar_cuda(pre, phi)
    b = tl.kron_pulsar_cuda(pre, phi)
    pl = tl.kron_pulsar_plain(pre, phi)
    for x, y, q in zip(a[:4], b[:4], pl[:4]):
        assert torch.equal(x.view(torch.int64), y.view(torch.int64))
        assert tol.vector_rel(x.cpu().numpy(), q.cpu().numpy()) \
            <= tol.KRON_PULSAR_REL
    assert torch.equal(a[2], a[2].transpose(-1, -2))
    for x, y, q in zip(a[4:], b[4:], pl[4:]):  # L and X for K5b
        assert torch.equal(x.view(torch.int64), y.view(torch.int64))
        assert tol.vector_rel(x.cpu().numpy(), q.cpu().numpy()) \
            <= tol.KRON_PULSAR_REL
    assert torch.all(torch.triu(a[4], diagonal=1) == 0)
    cots = [torch.tensor(rng.standard_normal(t.shape), device=card)
            for t in a[:4]]
    g1 = tl.kron_pulsar_bwd_cuda(phi, a[4], a[5], *cots)
    g2 = tl.kron_pulsar_bwd_cuda(phi, a[4], a[5], *cots)
    gp = tl.kron_pulsar_bwd_plain(phi, a[4], a[5], *cots)
    assert torch.equal(g1.view(torch.int64), g2.view(torch.int64))
    assert tol.vector_rel(g1.cpu().numpy(), gp.cpu().numpy()) \
        <= tol.KRON_PULSAR_REL
    assert torch.all(g1[:, 0, -3:] == 0)
    # the autograd.Function launches both kernels
    n5, n5b = tl.K5.launches, tl.K5B.launches
    q = phi.clone().requires_grad_(True)
    torch.autograd.grad(tl.kron_pulsar_terms(pre, q), q, cots)
    assert (tl.K5.launches, tl.K5B.launches) == (n5 + 1, n5b + 1)


def test_k5_failed_pivot_is_nan(card):
    """A capacity that is not positive definite turns every output of
    its block NaN, L included, as cho_factor does; the other blocks are
    untouched."""
    from pint_tpu_torch import linalg as tl

    pre = _grams(card, 3, 3, 29, 28)
    g_uu = pre.g_uu.clone()
    g_uu[1] = -1e30 * torch.eye(29, device=card, dtype=torch.float64)
    pre = pre._replace(g_uu=g_uu)
    phi = torch.full((2, 3, 29), 1e-14, device=card, dtype=torch.float64)
    out = tl.kron_pulsar_cuda(pre, phi)
    ref = tl.kron_pulsar_plain(pre, phi)
    for x, y in zip(out, ref):
        assert torch.all(torch.isnan(x[:, 1]))
        assert torch.all(torch.isfinite(x[:, [0, 2]]))
        assert torch.all(torch.isnan(y[:, 1]))


@pytest.mark.parametrize("nb", [145, 157, 203, 470, 1500, 3000, 3304])
def test_k5_k5b_wide_against_plain_and_deterministic(card, nb):
    """The wide forms K5w/K5bw, taken where the narrow forms' shared
    memory does not hold the capacity (145 and 157: K5w with the narrow
    K5b, X, gM and gx staged; 203 and 470: both wide; 470 is a
    pulsar of 400 ECORR epochs and 30 red-noise modes; 1500 and 3000,
    one pulsar and two chains: the 16- and 8-column panels; 3304, one
    chain: the widest the forms take, their shared memory at the card's
    limit), against the plain versions, bit-identical run to run, L's
    upper triangle zero, M exactly symmetric, a zero weight pinned with
    no gradient."""
    from pint_tpu_torch import linalg as tl
    from pint_tpu_torch import tolerances as tol

    m2, p, c = (28, 4, 3) if nb < 1000 else (28, 1, 2 if nb <= 3000 else 1)
    fwd, bwd = tl._k5_shape(nb, m2)
    pre = _grams(card, nb, p, nb, m2, n=nb + 100)
    rng = np.random.default_rng(4)
    phi_np = 10.0 ** rng.uniform(-16, -12, (c, p, nb))
    phi_np[:, 0, -3:] = 0.0
    phi = torch.tensor(phi_np, device=card)
    n5, n5w = tl.K5.launches, tl.K5W.launches
    a = tl.kron_pulsar_cuda(pre, phi)
    b = tl.kron_pulsar_cuda(pre, phi)
    assert fwd == "wide" and tl.K5W.launches == n5w + 2 \
        and tl.K5.launches == n5
    pl = tl.kron_pulsar_plain(pre, phi)
    for x, y, q in zip(a, b, pl):
        assert torch.equal(x.view(torch.int64), y.view(torch.int64))
        assert tol.vector_rel(x.cpu().numpy(), q.cpu().numpy()) \
            <= tol.KRON_PULSAR_REL
    assert torch.equal(a[2], a[2].transpose(-1, -2))
    assert torch.all(torch.triu(a[4], diagonal=1) == 0)
    cots = [torch.tensor(rng.standard_normal(t.shape), device=card)
            for t in a[:4]]
    nbw = tl.K5BW.launches
    g1 = tl.kron_pulsar_bwd_cuda(phi, a[4], a[5], *cots)
    g2 = tl.kron_pulsar_bwd_cuda(phi, a[4], a[5], *cots)
    assert tl.K5BW.launches == nbw + (2 if bwd == "wide" else 0)
    gp = tl.kron_pulsar_bwd_plain(phi, a[4], a[5], *cots)
    assert torch.equal(g1.view(torch.int64), g2.view(torch.int64))
    assert tol.vector_rel(g1.cpu().numpy(), gp.cpu().numpy()) \
        <= tol.KRON_PULSAR_REL
    assert torch.all(g1[:, 0, -3:] == 0)


def test_k5_wide_failed_pivot_is_nan(card):
    """A capacity that is not positive definite turns every output of
    its K5w block NaN, L included; the other blocks are untouched."""
    from pint_tpu_torch import linalg as tl

    pre = _grams(card, 3, 3, 203, 28, n=300)
    g_uu = pre.g_uu.clone()
    g_uu[1] = -1e30 * torch.eye(203, device=card, dtype=torch.float64)
    pre = pre._replace(g_uu=g_uu)
    phi = torch.full((2, 3, 203), 1e-14, device=card, dtype=torch.float64)
    out = tl.kron_pulsar_cuda(pre, phi)
    ref = tl.kron_pulsar_plain(pre, phi)
    for x, y in zip(out, ref):
        assert torch.all(torch.isnan(x[:, 1]))
        assert torch.all(torch.isfinite(x[:, [0, 2]]))
        assert torch.all(torch.isnan(y[:, 1]))


def test_k5b_route_matches_the_library(card):
    """The launcher's route (linalg._k5_shape, on the host) and K5b's
    own shared-memory size agree: 0 from the library exactly where the
    host routes to K5bw, and elsewhere at least the host's bytes of L's
    tiles (more where the library stages X, gM and gx beside them)."""
    from pint_tpu_torch import linalg as tl

    for nb in (1, 7, 8, 9, 63, 64, 65, 144, 157, 158, 170, 184, 185, 203):
        for m2 in (0, 1, 5, 28, 60, 400):
            host = tl.k5_shared_bytes(nb, m2)[1]
            lib = tl.K5B.call("kron_pulsar_bwd_smem", nb, m2)
            narrow = tl._k5_shape(nb, m2)[1] == "narrow"
            assert (lib > 0) == narrow and (not narrow or lib >= host), \
                (nb, m2, host, lib)


@pytest.mark.parametrize("nb,m2", [(161, 28), (184, 28), (20, 300)])
def test_k5b_unstaged_against_plain_and_deterministic(card, nb, m2):
    """The narrow K5b where X, gM and gx do not fit beside L's tiles and
    are read from global memory: past nb = 160 at m2 = 28, up to its
    limit there (184), and a narrow pulsar with many modes (m2 = 300).
    Against the plain version, bit-identical run to run, a zero weight
    pinned with no gradient."""
    from pint_tpu_torch import linalg as tl
    from pint_tpu_torch import tolerances as tol

    p, c = 4, 3
    assert tl._k5_shape(nb, m2)[1] == "narrow"
    # the library's bytes are the tiles' alone: nothing staged
    assert tl.K5B.call("kron_pulsar_bwd_smem", nb, m2) \
        == tl.k5_shared_bytes(nb, m2)[1]
    pre = _grams(card, nb + m2, p, nb, m2, n=nb + m2 + 100)
    rng = np.random.default_rng(6)
    phi_np = 10.0 ** rng.uniform(-16, -12, (c, p, nb))
    phi_np[:, 0, -3:] = 0.0
    phi = torch.tensor(phi_np, device=card)
    a = tl.kron_pulsar_cuda(pre, phi)
    cots = [torch.tensor(rng.standard_normal(t.shape), device=card)
            for t in a[:4]]
    n5b, nbw = tl.K5B.launches, tl.K5BW.launches
    g1 = tl.kron_pulsar_bwd_cuda(phi, a[4], a[5], *cots)
    g2 = tl.kron_pulsar_bwd_cuda(phi, a[4], a[5], *cots)
    assert (tl.K5B.launches, tl.K5BW.launches) == (n5b + 2, nbw)
    gp = tl.kron_pulsar_bwd_plain(phi, a[4], a[5], *cots)
    assert torch.equal(g1.view(torch.int64), g2.view(torch.int64))
    assert tol.vector_rel(g1.cpu().numpy(), gp.cpu().numpy()) \
        <= tol.KRON_PULSAR_REL
    assert torch.all(g1[:, 0, -3:] == 0)


def test_k5_wide_panel_and_width_limit(card):
    """The library chooses the wide forms' panel (the widest of 32, 16,
    8 columns whose shared memory fits) and refuses a pulsar too wide
    for it: the launchers raise before any launch."""
    from pint_tpu_torch import linalg as tl

    assert [tl.k5_wide_panel(nb) for nb in (145, 470, 1500, 3000, 4000)] \
        == [32, 32, 16, 8, 0]
    # the widest nb (its card test above) and the first too wide
    assert [tl.k5_wide_panel(nb) for nb in (3304, 3305)] == [8, 0]
    nb, m2 = 4000, 2
    z = torch.zeros(1, device=card, dtype=torch.float64)
    pre = tl.KronGram(
        torch.zeros((1, nb, nb), device=card, dtype=torch.float64),
        torch.zeros((1, nb, m2), device=card, dtype=torch.float64),
        torch.zeros((1, m2, m2), device=card, dtype=torch.float64),
        torch.zeros((1, nb), device=card, dtype=torch.float64),
        torch.zeros((1, m2), device=card, dtype=torch.float64), z, z)
    phi = torch.ones((1, 1, nb), device=card, dtype=torch.float64)
    n5w = tl.K5W.launches
    with pytest.raises(ValueError, match="shared memory"):
        tl.kron_pulsar_cuda(pre, phi)
    assert tl.K5W.launches == n5w


@pytest.mark.parametrize("n,p", [(10000, 11), (300, 3), (70000, 17)])
def test_k7_against_plain_and_deterministic(card, n, p):
    """K7 against wls_whiten_plain: rw bit-identical, Jn, the norms and
    chi2 within 1e-13 (summation order only), a zero column's norm 1,
    bit-identical run to run."""
    from pint_tpu_torch import linalg as tl
    from pint_tpu_torch import tolerances as tol

    rng = np.random.default_rng(n + p)
    r = torch.tensor(rng.standard_normal(n) * 1e-6, device=card)
    J = torch.tensor(rng.standard_normal((n, p)) * 10.0 ** rng.uniform(
        -8, 8, p), device=card)
    J[:, -1] = 0.0
    err = torch.tensor(rng.uniform(0.5, 2.0, n) * 1e-6, device=card)
    k0 = tl.K7.launches
    a = tl.wls_whiten_cuda(r, J, err)
    b = tl.wls_whiten_cuda(r, J, err)
    assert tl.K7.launches == k0 + 2
    pl = tl.wls_whiten_plain(r, J, err)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int64), y.view(torch.int64))
    assert torch.equal(a[0], pl[0])
    assert float(a[2][-1]) == 1.0
    for x, q in zip(a[1:], pl[1:]):
        assert tol.vector_rel(x.cpu().numpy(), q.cpu().numpy()) \
            <= tol.WLS_WHITEN_REL


@pytest.mark.parametrize("p", [1, 11, 31, 32])
@pytest.mark.parametrize("g", [1, 256])
@pytest.mark.parametrize("per_point_err", [False, True])
def test_k7_tiles_against_plain_and_deterministic(card, p, g,
                                                  per_point_err):
    """K7 at N = 10007 (no whole number of row tiles), G = 1 (one
    cooperative launch) and 256 (two launches), err shared (err_stride
    0) or one row a point (N), a zero column: rw and, where the norms
    are equal, Jn bit-identical to plain, the rest within
    WLS_WHITEN_REL, bit-identical run to run; a point of the batch is
    the unbatched call's bits (one tile cut, one order), and a J that
    is not 16-byte aligned gives the same bits."""
    from pint_tpu_torch import linalg as tl
    from pint_tpu_torch import tolerances as tol

    n = 10_007
    rng = np.random.default_rng(7 * p + g)
    r = torch.tensor(rng.standard_normal((g, n)) * 1e-6, device=card)
    J = torch.tensor(rng.standard_normal((g, n, p)) * 10.0 ** rng.uniform(
        -8, 8, p), device=card)
    J[:, :, p // 2] = 0.0
    err = torch.tensor(rng.uniform(0.5, 2.0, (g, n) if per_point_err
                                   else n) * 1e-6, device=card)
    assert tl.K7.call("wls_whiten_cooperative", g, n, p) == (g == 1)
    a = tl.wls_whiten_cuda(r, J, err)
    b = tl.wls_whiten_cuda(r, J, err)
    pl = tl.wls_whiten_plain(r, J, err)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int64), y.view(torch.int64))
    assert torch.equal(a[0], pl[0])
    assert torch.all(a[2][:, p // 2] == 1.0)
    same = torch.all(a[2] == pl[2], dim=-1)
    assert torch.equal(a[1][same], pl[1][same])
    for x, q in zip(a[1:], pl[1:]):
        assert tol.vector_rel(x.cpu().numpy(), q.cpu().numpy()) \
            <= tol.WLS_WHITEN_REL
    e0 = err[-1] if per_point_err else err
    one = tl.wls_whiten_cuda(r[-1], J[-1], e0)
    for x, y in zip(one, a):
        assert torch.equal(x.view(torch.int64), y[-1].view(torch.int64))
    buf = torch.empty(n * p + 1, dtype=torch.float64, device=card)
    odd = buf[1:].view(n, p)
    odd.copy_(J[-1])
    assert odd.data_ptr() % 16 == 8
    for x, y in zip(tl.wls_whiten_cuda(r[-1], odd, e0), one):
        assert torch.equal(x.view(torch.int64), y.view(torch.int64))


def test_wls_fit_from_par_tim_on_card(card):
    """WLSFitter from the committed par and tim on the card, one K7
    launch per iteration."""
    from pint_tpu_torch import linalg as tl
    from pint_tpu_torch.fitter import WLSFitter
    from pint_tpu_torch.models.builder import get_model_and_toas
    from pint_tpu_torch.convert import B1855_PAR, B1855_TIM

    model, toas = get_model_and_toas(str(B1855_PAR), str(B1855_TIM))
    f = WLSFitter(toas, model)
    k0 = tl.K7.launches
    chi2 = f.fit_toas(maxiter=3)
    assert np.isfinite(chi2)
    assert tl.K7.launches == k0 + len(f.chi2_iters)


def _k6_ulps(a, b):
    """|a - b| in units of the spacing at b, 0 where both are equal or
    both NaN."""
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    sp = torch.abs(torch.nextafter(b, torch.full_like(b, np.inf)) - b)
    return torch.where(same, torch.zeros_like(a), torch.abs(a - b) / sp)


@pytest.mark.parametrize("n_leap", [1, 4, 12])
@pytest.mark.parametrize("nd", [1, 40, 138, 300])
def test_k6_against_plain(card, n_leap, nd):
    """Three draws (adapting, adapting_next) = (T, T), (T, F), (F, F)
    through K6's n_leap + 1 launches a draw against the plain pre, post
    and end in turn on the same states, random numbers and gradients,
    chains going inactive at different steps; after every draw: the same
    accept decisions, every state within K6_ULPS, and bit-identical from
    run to run."""
    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.gw import hmc

    rng = np.random.default_rng(nd * 100 + n_leap)
    c = 5

    def t(a):
        return torch.tensor(np.asarray(a, np.float64), device=card)
    im = t(rng.uniform(0.1, 0.3, nd))
    x0, g0 = t(rng.standard_normal((c, nd))), t(rng.standard_normal((c, nd)))
    lnp0 = t(1e5 + rng.standard_normal(c))
    draws = []
    for _ in range(3):
        n = rng.integers(1, n_leap + 1, c)
        n[0], n[-1] = 1, n_leap
        draws.append((t(rng.standard_normal((c, nd))),
                      torch.tensor(n, device=card), t(rng.uniform(0, 1, c)),
                      [(t(1e5 + rng.standard_normal(c)),
                        t(rng.standard_normal((c, nd))))
                       for _ in range(n_leap)]))

    def draw(st, d, fused):
        z, n, u, grads = draws[d]
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
            hmc.nuts_draw_finish(st, n_leap - 1, d < 2, d + 1 < 2, 0.8, d)
        else:
            hmc.nuts_draw_end_plain(st, d < 2, d + 1 < 2, 0.8, d)

    k, k2, p = (hmc.NutsState(x0.clone(), g0.clone(), lnp0.clone(), im, 0.1)
                for _ in range(3))
    hmc.K6.launches = 0
    for d in range(3):
        for st, fused in ((k, True), (k2, True), (p, False)):
            draw(st, d, fused)
        torch.cuda.synchronize()
        assert torch.equal(k.accepted, p.accepted), d
        assert torch.equal(k.divergent, p.divergent), d
        for name in ("x", "g", "lnp", "x1", "p1", "g1", "lnp1", "xn", "ph",
                     "eps", "eps_used", "log_eps", "log_eps_bar", "hbar",
                     "acc"):
            a, b = getattr(k, name), getattr(p, name)
            assert float(torch.max(_k6_ulps(a, b))) <= tol.K6_ULPS, (d, name)
        for a, b in zip(k.tensors(), k2.tensors()):
            assert _bits_equal_nan(a, b), d
    assert hmc.K6.launches == 2 * 3 * (n_leap + 1)


def test_hmc_on_card_counts_launches(card):
    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.convert import load_pta_case
    from pint_tpu_torch.gw.common import CommonProcess
    from pint_tpu_torch.gw.hmc import K6, GWBPosterior, run_nuts
    from pint_tpu_torch.linalg import K5, K5B

    _, pairs = load_pta_case()
    post = GWBPosterior(CommonProcess(pairs[:6], nmodes=14, device=card))
    cpu = GWBPosterior(CommonProcess(pairs[:6], nmodes=14, device="cpu"))
    th = post.initial_chains(3, seed=1, ball=1.0)
    lc, gc = post.value_and_grad(torch.tensor(th, device=card))
    lp, gp = cpu.value_and_grad(torch.tensor(th))
    assert torch.all(torch.abs(lc.cpu() / lp - 1) <= tol.GW_LNLIKE_REL)
    assert float(torch.max(torch.abs(gc.cpu() - gp))
                 / torch.max(torch.abs(gp))) <= tol.HMC_GRAD_REL
    K5.launches = K5B.launches = K6.launches = 0
    res = run_nuts(post, n_chains=2, num_warmup=2, num_samples=2, chunk=2,
                   num_leapfrog=3, seed=0)
    assert np.all(np.isfinite(res.samples))
    assert K5.launches == K5B.launches == 1 + 4 * 3
    assert K6.launches == 4 * (3 + 1)  # n_leap + 1 a draw


def _k8_case(card, g, n, k_pre, k_e, seed, outside=True):
    """A structured basis (k_pre dense columns, k_e epochs, the offset
    column) with its Woodbury factor, and g residual vectors."""
    from pint_tpu_torch import linalg as tl

    rng = np.random.default_rng(seed)
    seg = rng.integers(0, k_e + (1 if outside else 0), n) if k_e \
        else np.zeros(n, np.int64)
    pre = rng.standard_normal((n, k_pre))
    post = np.ones((n, 1))
    su = tl.structured_from_blocks(pre, seg, k_e, post, card)
    sigma = torch.tensor(rng.uniform(0.5, 2.0, n) * 1e-6, device=card)
    phi = torch.tensor(np.concatenate([
        10.0 ** rng.uniform(-14, -12, k_pre), np.full(k_e, 1e-13),
        [1e30]]), device=card)
    pre_w = tl.woodbury_precompute(sigma, su, phi)
    R = torch.tensor(rng.standard_normal((g, n)) * 1e-6 + 3e-6, device=card)
    return pre_w, R


@pytest.mark.parametrize("g", [1, 16, 37, 256])
@pytest.mark.parametrize("basis", ["epochs", "no_epochs", "all_in_epochs"])
def test_k8_against_plain_and_deterministic(card, g, basis):
    """K8 against its plain version at the grid's shape (N = 10^4, 60
    dense columns + the offset, 400 epochs): within
    tolerances.WOODBURY_PRE_REL of sum r^2/n, bit-identical run to run,
    one launch for all g vectors (the chain's 16, the grid's 256, and
    37, a multiple of neither point tile); an epoch-free basis and one
    where every row lies in an epoch too."""
    from pint_tpu_torch import linalg as tl
    from pint_tpu_torch import tolerances as tol

    k_e = 0 if basis == "no_epochs" else 400
    pre, R = _k8_case(card, g, 10_000, 60, k_e, seed=g,
                      outside=basis == "epochs")
    parts = tl._basis_parts(pre.U, R.shape[1], card)
    k0 = tl.K8.launches
    a = tl.woodbury_chi2_pre_cuda(R, pre.nvec, *parts, pre.chol_upper)
    b = tl.woodbury_chi2_pre_cuda(R, pre.nvec, *parts, pre.chol_upper)
    assert tl.K8.launches == k0 + 2
    p = tl.woodbury_chi2_pre_plain(R, pre.nvec, *parts, pre.chol_upper)
    assert torch.equal(a.view(torch.int64), b.view(torch.int64))
    scale = torch.sum(R * R / pre.nvec, dim=1)
    assert float(torch.max(torch.abs(a - p) / scale)) <= tol.WOODBURY_PRE_REL
    one = tl.woodbury_chi2_logdet_pre(R[0], pre)[0]
    assert one.shape == () and float(torch.abs(one - a[0]) / scale[0]) \
        <= tol.WOODBURY_PRE_REL


@pytest.mark.parametrize("g,n,k_pre,k_e,k_post,rows,splits", [
    (256, 10_000, 60, 400, 1, 352, 29),   # the GLS grid
    (16, 10_000, 60, 400, 1, 64, 157),    # the GLS chain
    (1, 10_000, 60, 400, 1, 64, 157),
    (37, 300, 7, 20, 2, 32, 10),
    (5, 4000, 3600, 40, 1, 2016, 2),      # 57 column groups
    (3, 50, 0, 4, 0, 32, 2),              # no dense column
])
def test_k8_plan(card, g, n, k_pre, k_e, k_post, rows, splits):
    """K8's launch plan, as its library decides it: whole 32-row chunks
    per split, splits covering the rows with none empty, and at most
    264 first-stage blocks (two on each of 132 SMs; 32-point tiles by
    64 dense columns per split, plus one per diagonal block of L) while
    a split keeps a chunk."""
    from pint_tpu_torch import linalg as tl

    plan = tl.k8_plan(g, n, k_pre, k_e, k_post)
    assert (plan["rows"], plan["splits"]) == (rows, splits)
    assert rows % 32 == 0 and (splits - 1) * rows < n <= splits * rows
    tiles_a, nc = -(-g // 32), max(1, -(-(k_pre + k_post) // 64))
    panels = -(-(k_pre + k_e + k_post) // 32)
    assert plan["blocks"] == panels + splits * tiles_a * nc
    if rows > 32:
        assert plan["blocks"] <= 264
    assert plan["scratch"] > 0


def test_k8_past_one_blocks_shared_memory(card):
    """K = 3641 with 3600 dense columns: 57 column groups in the first
    stage, 114 panels in the substitution (z past its 64 shared-memory
    panels lives in the scratch), more than one block's shared memory
    holds."""
    from pint_tpu_torch import linalg as tl
    from pint_tpu_torch import tolerances as tol

    pre, R = _k8_case(card, 5, 4000, 3600, 40, seed=5)
    parts = tl._basis_parts(pre.U, R.shape[1], card)
    a = tl.woodbury_chi2_pre_cuda(R, pre.nvec, *parts, pre.chol_upper)
    b = tl.woodbury_chi2_pre_cuda(R, pre.nvec, *parts, pre.chol_upper)
    p = tl.woodbury_chi2_pre_plain(R, pre.nvec, *parts, pre.chol_upper)
    assert torch.equal(a.view(torch.int64), b.view(torch.int64))
    scale = torch.sum(R * R / pre.nvec, dim=1)
    assert float(torch.max(torch.abs(a - p) / scale)) <= tol.WOODBURY_PRE_REL


def test_k8_failed_factor_is_nan(card):
    from pint_tpu_torch import linalg as tl

    pre, R = _k8_case(card, 3, 500, 4, 10, seed=1)
    bad = pre._replace(chol_upper=torch.full_like(pre.chol_upper, np.nan))
    assert torch.all(torch.isnan(tl.woodbury_chi2_logdet_pre(R, bad)[0]))


def test_batched_k1_k2_k7_against_plain(card):
    """Under torch.func.vmap on the card: one launch per batched call,
    K1 and K2 bit-identical to their plain versions, K7 within
    tolerances.WLS_WHITEN_REL."""
    from pint_tpu_torch import fixedpoint as fp
    from pint_tpu_torch import linalg as tl
    from pint_tpu_torch import tolerances as tol

    rng = np.random.default_rng(3)
    t = torch.tensor(rng.integers(-2**50, 2**50, 5000))
    f0 = torch.tensor(186.49408156698235 + rng.normal(0, 1e-9, 64))
    k1 = fp.K1.launches
    n, frac = torch.func.vmap(lambda f: fp.phase_f0_t(f, t.to(card)))(
        f0.to(card))
    assert fp.K1.launches == k1 + 1
    n_p, frac_p = fp.phase_f0_t_plain(f0[:, None], t)
    assert torch.equal(n.cpu(), n_p)
    assert torch.equal(frac.cpu().view(torch.int64), frac_p.view(torch.int64))

    seg = rng.integers(0, 401, 5000)
    perm, offsets = (torch.tensor(a) for a in tl.epoch_csr(seg, 400))
    x = torch.tensor(rng.standard_normal((32, 5000, 8)))
    k2 = tl.K2.launches
    out = torch.func.vmap(lambda y: tl.segment_sum_fixed_order(
        y, perm.to(card), offsets.to(card)))(x.to(card))
    assert tl.K2.launches == k2 + 1
    for i in (0, 31):
        ref = tl.segment_sum_plain(x[i], perm, offsets)
        assert torch.equal(out[i].cpu().view(torch.int64),
                           ref.view(torch.int64))

    r = torch.tensor(rng.standard_normal((32, 5000)) * 1e-6, device=card)
    J = torch.tensor(rng.standard_normal((32, 5000, 8)), device=card)
    err = torch.tensor(rng.uniform(0.5, 2.0, 5000) * 1e-6, device=card)
    k7 = tl.K7.launches
    got = torch.func.vmap(lambda a, b: tl.wls_whiten(a, b, err))(r, J)
    assert tl.K7.launches == k7 + 1
    ref = tl.wls_whiten_plain(r, J, err)
    assert torch.equal(got[0], ref[0])
    for a, b in zip(got[1:], ref[1:]):
        assert tol.vector_rel(a.cpu().numpy(), b.cpu().numpy()) \
            <= tol.WLS_WHITEN_REL


@pytest.mark.parametrize("kind", ["gls", "wls"])
def test_grid_launches_independent_of_points(card, kind):
    """A grid call over 2 or 8 points launches each kernel of its path
    as often: no kernel runs once per point; K8 runs once per GLS grid
    call, for the final chi^2."""
    from pint_tpu_torch import grid
    from pint_tpu_torch import linalg as tl
    from pint_tpu_torch.convert import (B1855_PAR, B1855_TIM,
                                        B1855_WHITE_PAR)
    from pint_tpu_torch.fixedpoint import K1
    from pint_tpu_torch.models.builder import get_model, get_model_and_toas

    model, toas = get_model_and_toas(str(B1855_PAR), str(B1855_TIM))
    if kind == "gls":
        names, kernels = ["M2", "SINI"], (K1, tl.K2, tl.K8)
        pts = np.stack([0.26 + np.linspace(-1, 1, 8) * 0.0075,
                        np.full(8, 0.999)], axis=1)
    else:
        model = get_model(str(B1855_WHITE_PAR))
        names, kernels = ["F0", "F1"], (K1, tl.K7)
        pts = np.stack([model.values["F0"] + np.linspace(-1, 1, 8) * 5e-14,
                        np.full(8, model.values["F1"])], axis=1)
    fn, _, _ = grid.make_grid_fn(toas, model, names)
    counts = []
    for g in (2, 8):
        before = [k.launches for k in kernels]
        chi2, _ = fn(pts[:g])
        assert torch.all(torch.isfinite(chi2))
        counts.append([k.launches - b for k, b in zip(kernels, before)])
    assert counts[0] == counts[1] and all(c > 0 for c in counts[0])
    if kind == "gls":  # K8 serves the final chi^2 alone
        assert counts[0][2] == 1


def _k9_inputs(card, h, nd, seed):
    """A whole step's inputs: the ensemble (2h, nd), its lnp and the
    proposals' lnp with the NaN and infinite cases, and each half's
    draws (u, idx, u_acc)."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-12, 3, nd)
    center = rng.normal(0, 1, nd) * 10.0 ** rng.uniform(-3, 3, nd)

    def t(a, dtype=torch.float64):
        return torch.tensor(np.asarray(a), dtype=dtype, device=card)
    x = t(center + scale * rng.standard_normal((2 * h, nd)))
    lnp = rng.normal(1e5, 3.0, 2 * h)
    lnp_prop = lnp + rng.normal(0.0, 3.0, 2 * h)
    lnp_prop[:3] = (np.nan, -np.inf, np.inf)[:h]
    lnp[3:4] = np.nan
    draws = [(t(rng.uniform(size=h)), t(rng.integers(0, h, h), torch.int64),
              t(rng.uniform(size=h))) for _ in range(2)]
    return x, t(lnp), t(lnp_prop), draws


def _k9_step(ts, inputs, a, fused):
    """One red-black step (gaps 0, 1, 2) on copies of the inputs: K9's
    three launches (``fused``) or its plain version, the plain propose
    and accept in turn; returns the buffers."""
    x0, lnp0, lnp_prop, draws = inputs
    buf = ts.StretchBuffers.around(x0.clone(), lnp0.clone())
    buf.lnp_prop.copy_(lnp_prop)
    move = ts.stretch_move if fused else ts.stretch_move_plain
    for gap in (0, 1, 2):
        move(buf, gap, draws, a)
    return buf


def _bits_equal_nan(a, b):
    if not a.is_floating_point():
        return torch.equal(a, b)
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a).view(torch.int64),
                                torch.nan_to_num(b).view(torch.int64)))


@pytest.mark.parametrize("h,nd", [(16, 10), (4096, 64), (3, 1),
                                  (16384, 40)])
@pytest.mark.parametrize("a", [2.0, 1.7])
def test_k9_bit_identical_to_plain(card, h, nd, a):
    """A whole step through K9's three launches against the plain
    propose and accept in turn on the same inputs: walkers, lnp,
    proposals, z, flags and counts bit-identical (a NaN equal to a NaN),
    and bit-identical run to run; (16384, 40) is past one wave of
    co-resident blocks."""
    from pint_tpu_torch import sampler as ts

    inputs = _k9_inputs(card, h, nd, h + nd)
    if (h, nd) == (16384, 40):
        assert h * nd > 256 * ts.K9.call("stretch_move_max_blocks")
    ts.K9.launches = 0
    outs = [_k9_step(ts, inputs, a, True), _k9_step(ts, inputs, a, True)]
    assert ts.K9.launches == 6
    outs.append(_k9_step(ts, inputs, a, False))
    torch.cuda.synchronize()
    for other in outs[1:]:
        for k, (p, q) in enumerate(zip(outs[0], other)):
            assert _bits_equal_nan(p.double(), q.double()), k
    acc, count = outs[0].accepted.tolist(), outs[0].counts.tolist()
    assert count == [sum(acc[:h]), sum(acc[h:])]
    # a NaN or -inf proposal lnp rejects, +inf accepts, a NaN walker lnp
    # rejects
    assert acc[:4] == [0, 0, 1, 0]


def test_chain_on_card_counts_launches(card):
    """The injected-draw Gaussian chain on the card: 3 K9 launches per
    step, and the plain chain's positions on the CPU bit for bit."""
    from pint_tpu_torch import sampler as ts

    mu = np.array([1.0, -2.0, 0.5])
    w = 1.0 / np.array([0.5, 2.0, 1.0])

    def lnpost(x):
        d = (x - torch.tensor(mu, device=x.device)) \
            * torch.tensor(w, device=x.device)
        return -0.5 * torch.sum(d * d)

    rng = np.random.default_rng(4)
    x0 = mu + 0.1 * rng.standard_normal((8, 3))
    draws = (rng.uniform(size=(30, 2, 4)), rng.integers(0, 4, (30, 2, 4)),
             rng.uniform(size=(30, 2, 4)))
    ts.K9.launches = 0
    got = ts.run_chain(lnpost, x0, 30, device=card, draws=draws)
    assert ts.K9.launches == 3 * 30
    ref = ts.run_chain(lnpost, x0, 30, device="cpu", draws=draws)
    assert np.array_equal(got["accepted"], ref["accepted"])
    assert np.array_equal(got["chain"], ref["chain"])
    s = ts.EnsembleSampler(lnpost, nwalkers=8, device=card)
    s.run_mcmc(s.initial_ball(mu, 0.1 * np.ones(3)), 20)
    assert np.all(np.isfinite(s.chain)) and 0 < s.acceptance < 1


@pytest.mark.parametrize("n,c,c0", [(10842, 72, 60), (32, 473, 0),
                                    (10842, 12, 0), (77, 9, 3), (33, 12, 0),
                                    (97, 12, 0), (225, 12, 0),
                                    (113 * 96 + 1, 72, 60), (2048, 32, 0),
                                    (2049, 9, 3), (100, 120, 40)])
def test_k10_bit_identical_to_plain_and_deterministic(card, n, c, c0):
    """K10 at the capture's shapes (GLS, WLS) and the fold's, against
    its plain version (the same order: bit-identical) and run to run;
    and at the boundaries of its 96-row splits and 32-row chunks: one
    split with pad rows (33), two (97), a last split of a chunk and a
    row (225), one split more than the capture's 113, 256 groups of 4
    outputs (the most the one-tile first pass takes; 32 whole reduce
    tiles), a ragged reduce tile (54 outputs), and the tiled first pass
    over two splits (c = 120 is past the one-tile pass)."""
    from pint_tpu_torch import linalg as tl

    rng = np.random.default_rng(n + c)
    A = torch.tensor(rng.standard_normal((n, c))
                     * 10.0 ** rng.uniform(-4, 4, c))
    w = torch.tensor(rng.uniform(0.5, 2.0, n) * 1e12)
    S0 = torch.tensor(rng.standard_normal((c, c - c0)))
    ref = tl.stream_moments_plain(S0.clone(), A, w, c0)
    a = tl.stream_moments_cuda(S0.to(card), A.to(card), w.to(card), c0)
    b = tl.stream_moments_cuda(S0.to(card), A.to(card), w.to(card), c0)
    assert torch.equal(a.view(torch.int64), b.view(torch.int64))
    assert torch.equal(a.cpu().view(torch.int64), ref.view(torch.int64))


def test_stream_on_card_counts_launches(card):
    """A WLS stream on the card: one K10 launch per incremental append
    and one per capture, and the CPU stream's decisions and values."""
    from pint_tpu_torch import linalg as tl
    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.convert import (B1855_STREAM_NIGHTS, B1855_TIM,
                                        B1855_WHITE_PAR)
    from pint_tpu_torch.fitter import WLSFitter
    from pint_tpu_torch.models.builder import get_model
    from pint_tpu_torch.toa import get_TOAs

    base = get_TOAs(str(B1855_TIM))[np.arange(0, 10000, 25)]
    back = get_TOAs(str(B1855_STREAM_NIGHTS))
    nights = [back[np.arange(25 * i, 25 * i + 6)] for i in range(3)]
    out = {}
    for dev in (card, torch.device("cpu")):
        m = get_model(str(B1855_WHITE_PAR))
        f = WLSFitter(base, m, bucket=True, device=dev)
        f.fit_toas(maxiter=3)
        tl.K10.launches = 0
        f.stream_prepare()
        reps = [f.append_refit(d, maxiter=3) for d in nights]
        out[dev.type] = (tl.K10.launches, [r["mode"] for r in reps],
                         np.array([m.values[k] for k in m.free_params]),
                         np.array([m.uncertainties[k]
                                   for k in m.free_params]),
                         reps[-1]["cond_log10"])
    assert out["cuda"][0] == 1 + 3 and out["cpu"][0] == 0
    assert out["cuda"][1] == out["cpu"][1] == ["incremental"] * 3
    lim = tol.fit_tolerances(out["cpu"][4])
    assert np.max(np.abs(out["cuda"][2] - out["cpu"][2]) / out["cpu"][3]) \
        <= lim["values_sigma"]


@pytest.mark.parametrize("p,m2,n_noise,g", [(68, 28, 3, 2), (12, 10, 25, 64),
                                            (5, 1, 0, 300), (169, 2, 1, 1),
                                            (5, 3, 2, 1), (68, 28, 0, 4),
                                            (68, 28, 3, 9), (101, 5, 2, 13),
                                            (169, 2, 0, 9)])
def test_k11_against_plain_and_deterministic(card, p, m2, n_noise, g):
    import chip_smoke
    from pint_tpu_torch import linalg as tl
    from pint_tpu_torch import tolerances as tol

    args = chip_smoke.k11_synthetic(p, m2, max(n_noise, 1), g)
    if n_noise == 0:  # no noise columns: the GW sector alone
        gram, _, orf, phi_gw = args
        k = p * m2
        args = (gram[-k:, -k:].contiguous(), gram.new_zeros(0), orf, phi_gw)
    s1, l1, _ = tl.crn_capacity_cuda(*args)
    s2, l2, _ = tl.crn_capacity_cuda(*args)
    sp, lp = tl.crn_capacity_plain(*(t.cpu() for t in args))
    assert torch.equal(s1.view(torch.int64), s2.view(torch.int64))
    assert torch.equal(l1.view(torch.int64), l2.view(torch.int64))
    lim = tol.crn_capacity_limit(p, tol.crn_block_kappa(
        args[2].cpu().numpy(), args[3].cpu().numpy()))
    s1, l1 = s1.cpu(), l1.cpu()
    for i in range(g):
        assert torch.max(torch.abs(s1[i] - sp[i])) \
            <= lim * torch.max(torch.abs(sp[i]))
        assert abs(float(l1[i] - lp[i])) \
            <= lim * (sp.shape[-1] + abs(float(lp[i])))


def test_k11_refuses_an_orf_wider_than_shared_memory(card):
    from pint_tpu_torch import linalg as tl

    f64 = dict(dtype=torch.float64, device=card)
    p = 170
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        tl.crn_capacity_cuda(torch.eye(p, **f64), torch.ones(0, **f64),
                             torch.eye(p, **f64), torch.ones((1, 1), **f64))


def test_k11_failed_block_is_nan(card):
    import chip_smoke
    from pint_tpu_torch import linalg as tl

    gram, phi_noise, orf, phi_gw = chip_smoke.k11_synthetic(6, 4, 2, 2)
    phi_gw[1, 2] = float("nan")
    s, ld, _ = tl.crn_capacity_cuda(gram, phi_noise, orf, phi_gw)
    kn = phi_noise.numel()
    cols = kn + torch.arange(6, device=card) * 4 + 2
    assert torch.isnan(s[1][cols[:, None], cols[None, :]]).all()
    assert torch.isnan(ld[1]) and torch.isfinite(ld[0])
    assert torch.isfinite(s[0]).all()


@pytest.mark.parametrize("p,m2,n_noise,g", [(68, 28, 3, 4), (12, 10, 25, 64),
                                            (5, 3, 2, 1), (119, 2, 1, 2),
                                            (68, 28, 0, 2), (33, 4, 2, 3),
                                            (169, 2, 1, 2)])
def test_k11b_against_plain_and_deterministic(card, p, m2, n_noise, g):
    import chip_smoke

    row = chip_smoke.k11b_compare(chip_smoke.k11b_synthetic(p, m2, n_noise,
                                                            g))
    assert row["run_to_run"] and row["err_over_limit"] <= 1.0, row


def test_k11b_refuses_inconsistent_shapes(card):
    from pint_tpu_torch import linalg as tl

    f64 = dict(dtype=torch.float64, device=card)
    p = 4
    with pytest.raises(ValueError, match="K = kn"):  # K != kn + P m2
        tl.crn_capacity_bwd_cuda(torch.zeros((1, p + 1, p + 1), **f64),
                                 torch.zeros(1, **f64), torch.ones(0, **f64),
                                 torch.ones((1, 1), **f64),
                                 torch.zeros((1, 1, p, p), **f64))


def test_k11_per_point_noise_against_plain(card):
    """K11 with a row of noise weights a point against its plain version;
    with every row equal, the same bits as with the one shared row."""
    import chip_smoke
    from pint_tpu_torch import linalg as tl
    from pint_tpu_torch import tolerances as tol

    _, _, pn, pg, _ = chip_smoke.k11b_synthetic(12, 10, 5, 6)
    gram, _, orf, _ = chip_smoke.k11_synthetic(12, 10, 5, 6, seed=12)
    s1, l1, _ = tl.crn_capacity_cuda(gram, pn, orf, pg)
    sp, lp = tl.crn_capacity_plain(*(t.cpu() for t in (gram, pn, orf, pg)))
    lim = tol.crn_capacity_limit(12, tol.crn_block_kappa(
        orf.cpu().numpy(), pg.cpu().numpy()))
    s1, l1 = s1.cpu(), l1.cpu()
    for i in range(6):
        assert torch.max(torch.abs(s1[i] - sp[i])) \
            <= lim * torch.max(torch.abs(sp[i]))
        assert abs(float(l1[i] - lp[i])) \
            <= lim * (sp.shape[-1] + abs(float(lp[i])))
    rows = pn[2].expand(6, -1).contiguous()
    a = tl.crn_capacity_cuda(gram, rows, orf, pg)[:2]
    b = tl.crn_capacity_cuda(gram, pn[2], orf, pg)[:2]
    assert all(torch.equal(x.view(torch.int64), y.view(torch.int64))
               for x, y in zip(a, b))


def test_dense_posterior_on_card(card):
    """The wide case's dense posterior on the card: lnprob and gradient
    at its 4 theta against the CPU's and the card's kron posterior; one
    K11 and one K11b launch a gradient, no K3 or K5."""
    from pint_tpu_torch import linalg as tl
    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.convert import (PTA4_WIDE, load_arrays,
                                        pta_case_from_arrays)
    from pint_tpu_torch.gw.common import CommonProcess
    from pint_tpu_torch.gw.hmc import GWBPosterior

    arrays = load_arrays(PTA4_WIDE)
    pairs = pta_case_from_arrays(arrays)
    nmodes = int(arrays["ref_nmodes"])
    theta = arrays["ref_theta"]
    for k in (tl.K3, tl.K5, tl.K5W, tl.K11, tl.K11B):
        k.launches = 0
    dense = GWBPosterior(CommonProcess(pairs, nmodes=nmodes, kron=False,
                                       device=card))
    lg, gg = (t.cpu().numpy() for t in dense.value_and_grad(
        torch.as_tensor(theta, device=card)))
    assert tl.K11.launches == tl.K11B.launches == 1
    assert tl.K3.launches == tl.K5.launches == tl.K5W.launches == 0
    refs = [GWBPosterior(CommonProcess(pairs, nmodes=nmodes, kron=kron,
                                       device=dev)).value_and_grad(
        torch.as_tensor(theta, device=dev))
        for kron, dev in ((False, "cpu"), (True, card))]
    for lr, gr in refs:
        lr, gr = lr.cpu().numpy(), gr.cpu().numpy()
        assert np.all(np.abs(lg / lr - 1) <= tol.GW_LNLIKE_REL)
        for a, b in zip(gg, gr):
            assert np.max(np.abs(a - b)) <= tol.HMC_GRAD_REL * np.max(
                np.abs(b))


def test_dd_bit_identical_on_card(card):
    import chip_smoke

    assert chip_smoke.dd_mismatches(n=100_000) == []


def test_dense_lnlike_on_card_counts_launches(card):
    """The wide case's dense likelihood on the card: K11 runs, K3 does
    not, and the card's answer is the CPU's and its own kron one's."""
    from pint_tpu_torch import linalg as tl
    from pint_tpu_torch import tolerances as tol
    from pint_tpu_torch.convert import (PTA4_WIDE, load_arrays,
                                        pta_case_from_arrays)
    from pint_tpu_torch.gw.common import CommonProcess

    arrays = load_arrays(PTA4_WIDE)
    pairs = pta_case_from_arrays(arrays)
    nmodes = int(arrays["ref_nmodes"])
    la, ga = (float(x) for x in arrays["ref_lnlike_point"])
    tl.K11.launches = tl.K3.launches = 0
    dense = CommonProcess(pairs, nmodes=nmodes, kron=False, device=card)
    got = dense.lnlike(la, ga)
    assert tl.K11.launches == 1 and tl.K3.launches == 0
    cpu = CommonProcess(pairs, nmodes=nmodes, kron=False, device="cpu")
    kron = CommonProcess(pairs, nmodes=nmodes, device=card)
    for ref in (cpu.lnlike(la, ga), kron.lnlike(la, ga),
                float(arrays["ref_lnlike"])):
        assert abs(got / ref - 1) <= tol.GW_LNLIKE_REL


@pytest.mark.parametrize("k", [1, 8, 68])
def test_k1_pulsar_axis_one_launch(card, k):
    """K1 under torch.func.vmap over a pulsar axis, as the PTA batch's
    fold calls it: one F0 a pulsar against its own (k, 500) ticks is one
    launch, bit-identical to the plain version per pulsar."""
    from pint_tpu_torch import fixedpoint as fp

    rng = np.random.default_rng(k)
    f0 = torch.tensor(100.0 + 400.0 * rng.random(k))
    t = torch.tensor(np.round(rng.uniform(-1, 1, (k, 500)) * 1.5e8
                              * 2.0**32).astype(np.int64))
    k0 = fp.K1.launches
    n, frac = torch.func.vmap(fp.phase_f0_t)(f0.to(card), t.to(card))
    assert fp.K1.launches == k0 + 1
    for i in range(k):
        n_ref, frac_ref = fp.phase_f0_t_plain(f0[i], t[i])
        assert torch.equal(n[i].cpu(), n_ref)
        assert torch.equal(frac[i].cpu().view(torch.int64),
                           frac_ref.view(torch.int64))


@pytest.mark.parametrize("k", [1, 8, 68])
def test_k7_pulsar_axis_one_launch(card, k):
    """K7 under torch.func.vmap over a pulsar axis with each pulsar's own
    err and zero-weight pad rows (err 1e30), as the batched WLS step
    calls it: one launcher call, rw and the equal-norm columns of Jn
    bit-identical to the plain version, the rest within WLS_WHITEN_REL."""
    from pint_tpu_torch import linalg as tl
    from pint_tpu_torch import tolerances as tol

    rng = np.random.default_rng(100 + k)
    n, p = 500, 8
    r = torch.tensor(rng.standard_normal((k, n)) * 1e-6)
    J = torch.tensor(rng.standard_normal((k, n, p)) * 10.0 ** rng.uniform(
        -8, 8, p))
    J[:, :, 3] = 0.0  # a pinned parameter's column
    err = torch.tensor(rng.uniform(0.5, 2.0, (k, n)) * 1e-6)
    err[:, 450:] = 1e30
    r[:, 450:] = 0.0
    J[:, 450:] = 0.0
    k0 = tl.K7.launches
    a = torch.func.vmap(tl.wls_whiten)(r.to(card), J.to(card), err.to(card))
    assert tl.K7.launches == k0 + 1
    pl = tl.wls_whiten_plain(r, J, err)
    assert torch.equal(a[0].cpu(), pl[0])
    assert torch.all(a[2][:, 3] == 1.0)
    same = torch.all(a[2].cpu() == pl[2], dim=-1)
    assert torch.equal(a[1].cpu()[same], pl[1][same])
    for x, q in zip(a[1:], pl[1:]):
        assert tol.vector_rel(x.cpu().numpy(), q.numpy()) \
            <= tol.WLS_WHITEN_REL


def _k12_case(card, w_rows, n, shared, seed=12):
    """K12's inputs on the card: (W, N) phases in [-0.5, 0.5), weights,
    and the packed rows of a 5-type template (every type K12 covers),
    one row per walker or one shared row."""
    from pint_tpu_torch import templates as tt

    t = tt.LCTemplate([tt.LCGaussian(0.03, 0.2), tt.LCLorentzian(0.03, 0.4),
                       tt.LCVonMises(40.0, 0.6),
                       tt.LCGaussian2(0.02, 0.04, 0.75),
                       tt.LCLorentzian2(0.02, 0.05, 0.9)],
                      norms=[0.15, 0.1, 0.1, 0.1, 0.1])
    rng = np.random.default_rng(seed)
    frac = torch.tensor(rng.uniform(-0.5, 0.5, (w_rows, n)), device=card)
    wts = torch.tensor(rng.beta(1.0, 2.0, n), device=card)
    rows_n = 1 if shared else w_rows
    p = torch.tensor(t.params)[None] * torch.tensor(
        1.0 + 0.02 * rng.standard_normal((rows_n, len(t.params))))
    types, rows, bg = tt.pack_template(t, p.to(card))
    return frac, wts, types, rows, bg


@pytest.mark.parametrize("w_rows,n,shared", [(16, 100_000, False),
                                             (1, 100_000, False),
                                             (16, 5_000, True),
                                             (3, 2049, False)])
def test_k12_against_plain_and_deterministic(card, w_rows, n, shared):
    from pint_tpu_torch import templates as tt
    from pint_tpu_torch import tolerances as tol

    for weighted in (True, False):
        frac, wts, types, rows, bg = _k12_case(card, w_rows, n, shared)
        wts = wts if weighted else None
        args = (frac, wts, types, rows, bg)
        got, again = tt.photon_lnlike_cuda(*args), tt.photon_lnlike_cuda(*args)
        plain = tt.photon_lnlike_plain(*args)
        lim = tol.k12_limit(n, tt.photon_lnlike_plain(
            *args, absolute=True).cpu().numpy())
        assert torch.equal(got.view(torch.int64), again.view(torch.int64))
        assert np.all(torch.abs(got - plain).cpu().numpy() <= lim)
        dens = tt.photon_lnlike_cuda(*args, density=True)
        assert torch.equal(dens.view(torch.int64), tt.photon_density_plain(
            frac, types, rows, bg).view(torch.int64))
        gb = tt.photon_lnlike_bwd_cuda(*args)
        assert torch.equal(gb.view(torch.int64),
                           tt.photon_lnlike_bwd_cuda(*args).view(torch.int64))
        blim = tol.k12b_limit(n, tt.photon_lnlike_bwd_plain(
            *args, absolute=True).cpu().numpy())
        assert np.all(torch.abs(gb - tt.photon_lnlike_bwd_plain(*args))
                      .cpu().numpy() <= blim)


def test_k12_binned_and_vmap_one_launch(card):
    """The binned profile through K12, and torch.func.vmap over walkers
    as one launch set."""
    from pint_tpu_torch import templates as tt

    frac, wts, types, rows, bg = _k12_case(card, 8, 3000, False)
    bins = torch.linspace(0.5, 1.5, 64, dtype=torch.float64, device=card)
    e = (torch.zeros(0, dtype=torch.int32, device=card),
         torch.zeros((1, 0, 8), dtype=torch.float64, device=card),
         torch.zeros(1, dtype=torch.float64, device=card))
    got = tt.photon_lnlike_cuda(frac, wts, *e, bins=bins, wrap=True)
    want = tt.photon_lnlike_plain(frac, wts, *e, bins=bins, wrap=True)
    assert torch.allclose(got, want, rtol=0, atol=1e-10)
    before = tt.K12.launches
    out = torch.func.vmap(lambda f, r, b: tt.photon_lnlike(
        f[None], wts, types, r[None], b.reshape(1), wrap=True)[0])(
            frac, rows, bg)
    assert tt.K12.launches - before == 1
    assert torch.equal(out, tt.photon_lnlike_cuda(frac, wts, types, rows,
                                                  bg, wrap=True))


def test_k12_lcfitter_gradient_is_k12b(card):
    """LCFitter's gradient on the card goes through K12b; the Hessian
    raises there."""
    from pint_tpu_torch import templates as tt

    t = tt.LCTemplate([tt.LCGaussian(0.04, 0.3), tt.LCVonMises(30.0, 0.8)],
                      norms=[0.3, 0.2])
    rng = np.random.default_rng(3)
    f = tt.LCFitter(t, rng.uniform(0, 1, 4000), rng.beta(1, 2, 4000),
                    device=card)
    before = (tt.K12.launches, tt.K12B.launches)
    v, g = f._val_grad(t.params)
    assert (tt.K12.launches - before[0], tt.K12B.launches - before[1]) \
        == (1, 1)
    fc = tt.LCFitter(t, f.phases, f.weights, device="cpu")
    vc, gc = fc._val_grad(t.params)
    assert abs(float(v) - float(vc)) <= 1e-9 * abs(float(vc))
    assert torch.allclose(g.cpu(), gc, rtol=1e-9, atol=1e-9)
    with pytest.raises(NotImplementedError, match="item 14"):
        f.param_uncertainties()
