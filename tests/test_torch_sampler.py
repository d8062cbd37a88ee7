"""The port's ensemble sampler (``pint_tpu_torch.sampler``) against
pint_tpu's on the CPU.

- ``fma_exact`` rounds once, as an IEEE fused multiply-add: equal to the
  exactly rounded a b + c (``fractions``) on random and cancelling
  operands;
- the stretch move's plain stages (propose, the posterior, accept)
  against JAX's ``_stretch_half`` at the same draws, walkers at scales from 1e-12 to
  1e3 and stretch scales a = 2 and 1.7: new walkers, lnp and decisions
  bit-identical;
- an 8-walker x 50-step chain on a Gaussian target with JAX's draws
  injected (replayed by ``tools/export_torch_mcmc_case.replay_draws``):
  positions bit-identical, lnp within 1e-13 relative, the same accept
  decisions and acceptance; K9 not launched on the CPU;
- ``integrated_autocorr_time`` and ``AutocorrCache`` against JAX's on
  white and AR(1) chains;
- ``EnsembleSampler.run_mcmc_autocorr`` converging on a 2-D Gaussian
  from the generator, recovering its variance;
- ``tolerances.chain_parting_step`` parts two chains only at a near
  tie decided otherwise;
- odd walkers, ``mesh=`` and ``checkpoint=`` raise; a chain stuck at
  -inf raises ``FitDivergedError`` carrying the initial ensemble; the
  entry points default to CUDA and raise without it.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu import sampler as jsampler
from pint_tpu_torch import sampler as ts
from pint_tpu_torch import tolerances as tol
from tools.export_torch_mcmc_case import replay_draws

# one intra-op thread: the tests run at small sizes, and pytest-xdist's
# workers share the machine's cores (torch's default of one thread per
# core in every worker oversubscribes them several times over)
torch.set_num_threads(1)


def _exact_fma(a, b, c):
    return np.array([float(Fraction(x) * Fraction(y) + Fraction(z))
                     for x, y, z in zip(a, b, c)])


def test_fma_exact_rounds_once():
    rng = np.random.default_rng(0)
    n = 4000
    a = np.concatenate([rng.uniform(0.5, 2.0, n),
                        rng.standard_normal(n) * 10.0 ** rng.uniform(-20, 20,
                                                                     n)])
    b = rng.standard_normal(2 * n) * 10.0 ** rng.uniform(-15, 5, 2 * n)
    c = rng.standard_normal(2 * n) * 10.0 ** rng.uniform(-15, 8, 2 * n)
    c[n // 2:n] = -(a * b)[n // 2:n] * (1 + 1e-15 * rng.standard_normal(
        n - n // 2))  # cancellation: the low bits decide
    got = ts.fma_exact(*(torch.tensor(v) for v in (a, b, c))).numpy()
    assert np.array_equal(got, _exact_fma(a, b, c))
    assert not np.array_equal(got, a * b + c)  # fused, not two roundings


def _walkers(rng, h, nd):
    scale = 10.0 ** rng.uniform(-12, 3, nd)
    center = rng.normal(0, 1, nd) * 10.0 ** rng.uniform(-3, 3, nd)
    act = center + scale * rng.standard_normal((h, nd))
    oth = center + scale * rng.standard_normal((h, nd))
    return center, scale, act, oth


@pytest.mark.parametrize("a", [2.0, 1.7])
@pytest.mark.parametrize("seed", [0, 1])
def test_stretch_half_plain_matches_jax_bitwise(a, seed):
    rng = np.random.default_rng(seed)
    h, nd = 64, 10
    center, scale, act, oth = _walkers(rng, h, nd)
    lnp_a = rng.normal(0.0, 3.0, h)
    lnp_a[:4] = (np.nan, -np.inf, np.inf, -1e300)

    # products only, so both packages round lnp alike (a sum's order, a
    # contracted multiply-add or XLA's division by a constant as a
    # product with its reciprocal would differ, and none is the move's)
    w = 1.0 / scale[0]

    def jl(v):
        d = (v[0] - center[0]) * w
        return -0.5 * (d * d)

    def tl(v):
        d = (v[0] - center[0]) * w
        return -0.5 * (d * d)

    key = jax.random.PRNGKey(seed)
    jnew, jlnp, jacc = jax.jit(lambda x, o, l: jsampler._stretch_half(
        key, x, o, l, jax.vmap(jl), a))(act, oth, lnp_a)
    k_z, k_idx, k_acc = jax.random.split(key, 3)
    u = np.asarray(jax.random.uniform(k_z, (h,)))
    idx = np.asarray(jax.random.randint(k_idx, (h,), 0, h))
    u_acc = np.asarray(jax.random.uniform(k_acc, (h,)))
    # the moving half is half 0 of an ensemble whose half 1 is ``oth``;
    # gap 1 accepts half 0 (and proposes half 1, which is not read)
    buf = ts.StretchBuffers.around(
        torch.tensor(np.concatenate([act, oth])),
        torch.tensor(np.concatenate([lnp_a, np.zeros(h)])))
    d = (torch.tensor(u), torch.tensor(idx), torch.tensor(u_acc))
    ts.stretch_move(buf, 0, (d, None), a)
    buf.lnp_prop[:h] = torch.func.vmap(tl)(buf.prop[:h])
    ts.stretch_move(buf, 1, (d, d), a)
    acc, new, lnp = buf.accepted[:h], buf.x[:h], buf.lnp[:h]
    assert 0 < int(buf.counts[0]) == int(acc.sum()) < h
    assert np.array_equal(acc.numpy().astype(bool), np.asarray(jacc))
    assert np.array_equal(new.numpy(), np.asarray(jnew))
    assert np.array_equal(lnp.numpy(), np.asarray(jlnp), equal_nan=True)


def test_stretch_accept_rejects_nan():
    """A NaN proposal lnp, or a NaN walker lnp, never accepts; a finite
    proposal from -inf and a +inf proposal do (XLA's fused multiply-add
    carries the infinity)."""
    h, nd = 5, 2
    buf = ts.StretchBuffers.around(
        torch.zeros((2 * h, nd), dtype=torch.float64),
        torch.tensor([0.0] * h + [0.0, np.nan, -np.inf, -np.inf, 0.0],
                     dtype=torch.float64))
    buf.prop.fill_(1.0)
    buf.z.fill_(1.5)
    buf.lnp_prop[h:] = torch.tensor([np.nan, 5.0, np.nan, 0.0, np.inf],
                                    dtype=torch.float64)
    # gap 2 accepts half 1 alone
    ts.stretch_move(buf, 2, (None, (None, None, torch.full(
        (h,), 0.5, dtype=torch.float64))))
    act, prop, lnp = buf.x[h:], buf.prop[h:], buf.lnp[h:]
    assert buf.accepted[h:].tolist() == [0, 0, 0, 1, 1]
    assert int(buf.counts[1]) == 2
    assert torch.equal(act[3:], prop[3:])
    assert lnp[3:].tolist() == [0.0, np.inf]
    assert torch.equal(act[:3], torch.zeros((3, nd), dtype=torch.float64))
    lnratio = jnp.asarray(9.0) * jnp.log(1.5) + jnp.asarray(np.inf) - 0.0
    assert bool(jnp.log(0.5) < lnratio)  # JAX accepts it too


def _ensemble(rng, h, nd):
    """Two halves of walkers in one (2h, nd) ensemble, their lnp with
    the NaN and infinite cases, and the draws of a step."""
    _, _, act, oth = _walkers(rng, h, nd)
    lnp = rng.normal(1e5, 3.0, 2 * h)
    lnp_prop = lnp + rng.normal(0.0, 3.0, 2 * h)
    lnp_prop[:3] = (np.nan, -np.inf, np.inf)[:h]
    lnp[3:4] = np.nan
    draws = [(torch.tensor(rng.uniform(size=h)),
              torch.tensor(rng.integers(0, h, h)),
              torch.tensor(rng.uniform(size=h))) for _ in range(2)]
    return (torch.tensor(np.concatenate([act, oth])), torch.tensor(lnp),
            torch.tensor(lnp_prop), draws)


def _bits(t):
    t = t.double()
    return torch.isnan(t), torch.nan_to_num(t).view(torch.int64)


@pytest.mark.parametrize("h,nd", [(16, 10), (3, 1), (64, 7)])
@pytest.mark.parametrize("a", [2.0, 1.7])
def test_stretch_move_fused_equals_plain_stages(h, nd, a):
    """A whole step through :func:`stretch_move` on CPU tensors (gaps 0,
    1, 2: propose half 0; accept half 0 and propose half 1; accept half
    1) against the plain propose and accept of each half in turn: every
    buffer bit for bit, NaN equal to NaN."""
    rng = np.random.default_rng(h * nd)
    x0, lnp0, lnp_prop, draws = _ensemble(rng, h, nd)

    def step(fused):
        buf = ts.StretchBuffers.around(x0.clone(), lnp0.clone())
        buf.lnp_prop.copy_(lnp_prop)
        if fused:
            for gap in (0, 1, 2):
                ts.stretch_move(buf, gap, draws, a)
            return buf
        for k, (s, o) in enumerate(((slice(0, h), slice(h, 2 * h)),
                                    (slice(h, 2 * h), slice(0, h)))):
            u, idx, u_acc = draws[k]
            buf.prop[s], buf.z[s] = ts.stretch_propose_plain(
                buf.x[s], buf.x[o], u, idx, a)
            ts.stretch_accept_plain(buf.x[s], buf.lnp[s], buf.prop[s],
                                    buf.z[s], buf.lnp_prop[s], u_acc,
                                    buf.accepted[s], buf.counts[k:k + 1])
        return buf

    got, ref = step(True), step(False)
    for g, r in zip(got, ref):
        assert all(torch.equal(p, q) for p, q in zip(_bits(g), _bits(r)))
    assert got.counts.tolist() == [int(got.accepted[:h].sum()),
                                   int(got.accepted[h:].sum())]


@pytest.mark.parametrize("nw,gap", [(8, 3), (8, -1), (7, 0)])
def test_stretch_move_refuses_what_is_not_a_red_black_gap(nw, gap):
    """A gap other than 0, 1 or 2, or an odd ensemble, raises before
    anything moves."""
    rng = np.random.default_rng(5)
    x, lnp = (torch.tensor(rng.standard_normal(s)) for s in ((nw, 2), nw))
    buf = ts.StretchBuffers.around(x, lnp)
    before = x.clone()
    d = (torch.full((nw // 2,), 0.5, dtype=torch.float64),
         torch.zeros(nw // 2, dtype=torch.int64),
         torch.full((nw // 2,), 0.5, dtype=torch.float64))
    with pytest.raises(ValueError, match="gap must be|even"):
        ts.stretch_move(buf, gap, (d, d))
    assert torch.equal(x, before)


MU = np.array([1.0, -2.0, 0.5])
SIG = np.array([0.5, 2.0, 1.0])


def _jgauss(x):
    return -0.5 * jnp.sum(((x - MU) / SIG) ** 2)


def _tgauss(x):
    return -0.5 * torch.sum(((x - torch.tensor(MU)) / torch.tensor(SIG))
                            ** 2)


@pytest.mark.parametrize("a", [2.0, 1.7])
def test_gaussian_chain_with_injected_draws_matches_jax(a):
    key = jax.random.PRNGKey(42)
    x0 = np.asarray(MU + 0.1 * jax.random.normal(key, (8, 3)))
    chain, lnp, acc = jsampler.run_mcmc(_jgauss, x0, 50, key=key, a=a)
    chain, lnp = np.asarray(chain), np.asarray(lnp)
    before = ts.K9.launches
    out = ts.run_chain(_tgauss, x0, 50, a=a, device="cpu",
                       draws=replay_draws(key, 50, 4))
    assert ts.K9.launches == before
    assert np.array_equal(out["chain"], chain)
    assert np.max(np.abs(out["lnp"] / lnp - 1)) <= 1e-13
    path = np.concatenate([x0[None], chain])
    assert np.array_equal(out["accepted"],
                          np.any(path[1:] != path[:-1], axis=-1))
    assert np.array_equal(out["counts"].sum(axis=1),
                          out["accepted"].sum(axis=1))
    got = ts.run_mcmc(_tgauss, x0, 50, a=a, device="cpu",
                      draws=replay_draws(key, 50, 4))
    assert np.array_equal(got[0], chain)
    assert abs(got[2] - float(acc)) <= 1e-7  # JAX's mean is float32
    thin = ts.run_mcmc(_tgauss, x0, 50, a=a, device="cpu", thin=5,
                       draws=replay_draws(key, 50, 4))
    assert np.array_equal(thin[0], chain[::5])


def _ar1(rng, rho=0.95, n=4000, nw=8):
    ar = np.empty((n, nw, 1))
    ar[0] = rng.standard_normal((nw, 1))
    for t in range(1, n):
        ar[t] = rho * ar[t - 1] + np.sqrt(1 - rho**2) * \
            rng.standard_normal((nw, 1))
    return ar


@pytest.mark.parametrize("kind", ["white", "ar1"])
def test_autocorr_matches_jax(kind):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4000, 8, 2)) if kind == "white"
         else _ar1(rng))
    tau = ts.integrated_autocorr_time(x)
    assert np.array_equal(tau, jsampler.integrated_autocorr_time(x))
    if kind == "white":
        assert np.all(np.abs(tau - 1.0) < 0.3)
    else:
        assert 0.5 * 39.0 < tau[0] < 2.0 * 39.0
    mine, ref = ts.AutocorrCache(lag0=64), jsampler.AutocorrCache(lag0=64)
    for i in range(0, 4000, 500):
        mine.update(x[i:i + 500])
        ref.update(x[i:i + 500])
        t_m = mine.tau(x[:i + 500])
        assert np.array_equal(t_m, ref.tau(x[:i + 500]))
        full = ts.integrated_autocorr_time(x[:i + 500])
        assert np.max(np.abs(t_m / full - 1)) <= 1e-9
    assert (mine.updates, mine.rebuilds) == (ref.updates, ref.rebuilds)


def test_run_mcmc_autocorr_converges_gaussian():
    def lnpost(x):
        return -0.5 * torch.sum(x**2, dim=-1)

    s = ts.EnsembleSampler(lnpost, nwalkers=32, seed=1, device="cpu")
    x0 = s.initial_ball(np.zeros(2), np.ones(2) * 0.5)
    chain, converged, tau = s.run_mcmc_autocorr(x0, chunk=200,
                                                maxsteps=4000)
    assert converged and chain.shape[1:] == (32, 2)
    flat = s.flatchain(burn=int(5 * np.max(tau)))
    assert np.all(np.abs(flat.std(axis=0) - 1.0) < 0.1)
    assert 0.2 < s.acceptance < 0.9
    best, lnp = s.max_posterior()
    assert lnp == float(np.max(s.lnprob)) and best.shape == (2,)


def test_chain_parting_step_only_at_a_near_tie_decided_otherwise():
    nsteps, h = 4, 2
    margin = np.ones((nsteps, 2, h))
    margin[2, 1, 0] = 1e-5  # a near tie: the lnp limits at 1e5 sum to 6e-4
    lnp = np.full((nsteps, 2, h), -1e5)
    ref = np.zeros((nsteps, 2 * h), bool)

    def parting(flips):
        acc = ref.copy()
        for step, walker in flips:
            acc[step, walker] = True
        return tol.chain_parting_step(margin, lnp, lnp, acc, ref)

    assert tol.near_ties(margin, lnp, lnp).sum() == 1
    assert parting([]) == nsteps
    assert parting([(2, h)]) == 2  # the tie, second half's first walker
    assert parting([(2, 0)]) == nsteps  # not a tie: the caller's check fails
    assert parting([(1, 1), (2, h)]) == 2


def test_odd_walkers_rejected():
    with pytest.raises(ValueError, match="even"):
        ts.run_mcmc(lambda x: torch.sum(x), np.zeros((7, 2)), 10,
                    device="cpu")


def test_mesh_and_checkpoint_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.run_mcmc(_tgauss, np.zeros((4, 3)), 2, device="cpu",
                    mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.EnsembleSampler(_tgauss, 4, device="cpu", mesh=object())
    s = ts.EnsembleSampler(_tgauss, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="checkpoint"):
        s.run_mcmc_autocorr(np.zeros((4, 3)), checkpoint="x.npz")


def test_stuck_chain_raises_with_last_good():
    x0 = np.arange(8.0).reshape(4, 2)
    with pytest.raises(ts.FitDivergedError) as e:
        ts.run_mcmc(lambda x: torch.sum(x) * 0.0 - np.inf, x0, 3,
                    device="cpu")
    assert np.array_equal(e.value.last_good, x0)
    assert e.value.health == {"positions_finite": True,
                              "any_finite_lnp": False}


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: ts.run_mcmc(_tgauss, np.zeros((4, 3)), 2),
                 lambda: ts.EnsembleSampler(_tgauss, 4),
                 lambda: ts.run_mcmc(_tgauss, np.zeros((4, 3)), 2,
                                     device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
