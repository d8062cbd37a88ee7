"""Streaming appends, the port against pint_tpu on the CPU.

- the bucket tables (``bucket_size``, ``pad_toas``, ``append_toas``):
  ticks, errors, flags, ``n_real``, ``n_filled``, ``pad_valid`` and
  ``in_bucket`` equal on TOAs both packages read from one tim;
- the normal-block functions (``normal_blocks`` ...
  ``woodbury_pre_append``) within ``tolerances.STREAM_BLOCKS_REL`` of
  JAX's on seeded inputs;
- ``stream_moments_plain`` (kernel K10's plain version) against a numpy
  float64 sum within ``tolerances.stream_moments_limit``;
- twins of tests/test_stream.py's TestAppendConsistency (WLS white, GLS
  red noise, GLS with ECORR epochs) and TestBucketBoundary: each
  night's mode, verdict, quarantine and captures equal JAX's, chi^2
  within ``tolerances.stream_chi2_limit``, values and uncertainties
  within ``tolerances.stream_fit_tolerances`` of the refit's condition
  number and centering ratio (a full fit's: its own), and the final
  values within 0.05 sigma of the port's own from-scratch fit; an
  ECORR-veto night and a quarantine night take JAX's mode and verdict;
  the recapture after the 8th refit; no O(N) pass (no capture, no
  full prepare) on a steady-state append.  TestZeroRecompile has no
  meaning in eager PyTorch: the last item is the invariant behind it.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pint_tpu import compile_cache as jcc
from pint_tpu import linalg as jla
from pint_tpu.fitter import GLSFitter as JGLSFitter
from pint_tpu.fitter import WLSFitter as JWLSFitter
from pint_tpu.models.builder import get_model as jget_model
from pint_tpu.simulation import make_fake_toas_uniform as jfake
from pint_tpu.toa import TOAs as JTOAs
from pint_tpu.toa import get_TOAs as jget_toas
from pint_tpu.toa import write_tim
from pint_tpu_torch import compile_cache as tcc
from pint_tpu_torch import linalg as tla
from pint_tpu_torch import tolerances as tol
from pint_tpu_torch.fitter import STREAM_RECAPTURE, GLSFitter, WLSFitter
from pint_tpu_torch.models import timing_model as ttm
from pint_tpu_torch.models.builder import get_model
from pint_tpu_torch.toa import get_TOAs

CPU = torch.device("cpu")

BASE_PAR = """
PSR J1744-1134
RAJ 17:44:29.4 1
DECJ -11:34:54.7 1
F0 245.4261196 1
F1 -5.38e-16 1
PEPOCH 54000
DM 3.139 1
TZRMJD 54000
TZRFRQ 1400
TZRSITE gbt
"""
WHITE = "EFAC -f fake 1.2\nEQUAD -f fake 0.5\n"
RED = "TNREDAMP -13.5\nTNREDGAM 3.5\nTNREDC 10\n"
ECORR = "ECORR -f fake 0.4\n"


def _fake(model, n, seed, start=53000.0, end=54800.0):
    return jfake(start, end, n, model, freq_mhz=1400.0, obs="gbt",
                 error_us=1.0, add_noise=True,
                 rng=np.random.default_rng(seed), flags={"f": "fake"})


def _night(model, i, n, seed, start=54801.0, width=0.2):
    s0 = start + 3.0 * i
    return jfake(s0, s0 + width, n, model, freq_mhz=1400.0, obs="gbt",
                 error_us=1.0, add_noise=True,
                 rng=np.random.default_rng(seed), flags={"f": "fake"})


def _both(tmp, name, toas):
    """(JAX TOAs, the port's TOAs) read from one tim."""
    path = str(tmp / f"{name}.tim")
    write_tim(toas, path)
    return jget_toas(path), get_TOAs(path)


# --------------------------------------------------------------------------
# bucket tables
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 64, 65, 80, 81, 125, 126, 10000, 10842,
                               10843])
def test_bucket_size_matches_jax(n):
    assert tcc.bucket_size(n) == jcc.bucket_size(n)


@pytest.fixture(scope="module")
def small_toas(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stream_tables")
    sim = jget_model(BASE_PAR + WHITE)
    base = _both(tmp, "base", _fake(sim, 70, 11))
    exact = _both(tmp, "exact", _fake(sim, 80, 12))
    night = _both(tmp, "night", _night(sim, 0, 6, 13))
    big = _both(tmp, "big", _night(sim, 1, 16, 14))
    return base, exact, night, big


def _table(t):
    return {"ticks": np.asarray(t.ticks), "error_us": np.asarray(t.error_us),
            "freq_mhz": np.asarray(t.freq_mhz),
            "flags": [dict(f) for f in t.flags],
            "n_real": getattr(t, "n_real", None),
            "n_filled": getattr(t, "n_filled", None),
            "pad_valid": None if getattr(t, "pad_valid", None) is None
            else np.asarray(t.pad_valid).tolist()}


def _assert_tables_equal(a, b):
    ta, tb = _table(a), _table(b)
    for k in ("ticks", "error_us", "freq_mhz"):
        assert np.array_equal(ta[k], tb[k]), k
    for k in ("flags", "n_real", "n_filled", "pad_valid"):
        assert ta[k] == tb[k], k


@pytest.mark.parametrize("case", ["pad", "boundary", "append_in_bucket",
                                  "append_overflow", "quarantine_hole"])
def test_pad_and_append_tables_match_jax(small_toas, case):
    (jb, tb), (je, te), (jn, tn), (jbig, tbig) = small_toas
    if case == "pad":
        _assert_tables_equal(tcc.pad_toas(tb), jcc.pad_toas(jb))
        assert len(tcc.pad_toas(tb)) == 80
        return
    if case == "boundary":
        tp, jp = tcc.pad_toas(te), jcc.pad_toas(je)
        _assert_tables_equal(tp, jp)
        assert te.n_real is None and tp.n_real == 80
        return
    delta_t, delta_j = (tn, jn) if case != "append_overflow" \
        else (tbig, jbig)
    base_t, base_j = tcc.pad_toas(tb), jcc.pad_toas(jb)
    if case == "quarantine_hole":
        base_t, _ = tcc.append_toas(base_t, tn[np.arange(2)])
        base_j, _ = jcc.append_toas(base_j, jn[np.arange(2)])
        for b in (base_t, base_j):
            pv = np.arange(len(b)) < b.n_filled
            pv[70] = False
            b.pad_valid = pv
    mt, in_t = tcc.append_toas(base_t, delta_t)
    mj, in_j = jcc.append_toas(base_j, delta_j)
    assert in_t == in_j == (case != "append_overflow")
    _assert_tables_equal(mt, mj)


# --------------------------------------------------------------------------
# normal blocks (linalg.py:772-1000)
# --------------------------------------------------------------------------

def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return tol.vector_rel(got, ref) if ref.size else 0.0


def _blocks_rel(tb, jb):
    return max(_rel(getattr(tb, k).numpy(), getattr(jb, k))
               for k in tb._fields)


def _system(seed, n=120, p=5, k_pre=6, k_e=10, k_post=1, dn=7):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal(n) * 1e-6
    J = rng.standard_normal((n, p)) * 10.0 ** rng.uniform(-3, 3, p)
    sigma = rng.uniform(0.5, 2.0, n) * 1e-6
    pre = rng.standard_normal((n, k_pre))
    seg = rng.integers(0, k_e + 1, n)
    post = np.ones((n, k_post))
    phi = np.concatenate([10.0 ** rng.uniform(-14, -12, k_pre),
                          np.full(k_e, 1e-13), np.full(k_post, 1e30)])
    valid = np.ones(n, dtype=bool)
    valid[-3:] = False
    d = {"r_d": rng.standard_normal(dn) * 1e-6,
         "J_d": rng.standard_normal((dn, p)) * 10.0 ** rng.uniform(-3, 3, p),
         "sigma_d": rng.uniform(0.5, 2.0, dn) * 1e-6,
         "U_d": np.concatenate([rng.standard_normal((dn, k_pre)),
                                np.eye(k_e)[rng.integers(0, k_e, dn)],
                                np.ones((dn, k_post))], axis=1),
         "valid_d": np.arange(dn) < dn - 2,
         "dpar": rng.standard_normal(p) * 1e-3}
    return r, J, sigma, (pre, seg, k_e, post), phi, valid, d


def _jsu(pre, seg, k_e, post):
    return jla.structured_from_dense_blocks(pre, seg, k_e, post)


def _tsu(pre, seg, k_e, post):
    return tla.structured_from_blocks(pre, seg, k_e, post, CPU)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("fn", [
    "normal_blocks_dense", "normal_blocks_structured", "normal_blocks_white",
    "normal_blocks_delta", "normal_blocks_shift", "normal_solve_from_blocks",
    "normal_solve_from_blocks_white", "noise_gram_append",
    "woodbury_pre_append", "su_dense_rows", "su_pad_rows"])
def test_normal_block_functions_match_jax(fn):
    r, J, sigma, blocks, phi, valid, d = _system(len(fn))
    su_j, su_t = _jsu(*blocks), _tsu(*blocks)
    dense = np.asarray(jla.su_to_dense(su_j))
    lim = tol.STREAM_BLOCKS_REL
    if fn.startswith("normal_blocks") or fn.startswith("normal_solve"):
        white = fn.endswith("white")
        Uj = jnp.zeros((len(r), 0)) if white else (
            jnp.asarray(dense) if fn.endswith("dense") else su_j)
        Ut = torch.zeros((len(r), 0), dtype=torch.float64) if white else (
            _t(dense) if fn.endswith("dense") else su_t)
        ph = phi[:0] if white else phi
        jb = jla.normal_blocks(jnp.asarray(r), jnp.asarray(J),
                               jnp.asarray(sigma), Uj, jnp.asarray(ph),
                               valid=jnp.asarray(valid))
        tb = tla.normal_blocks(_t(r), _t(J), _t(sigma), Ut, _t(ph),
                               valid=_t(valid))
        if fn == "normal_blocks_delta":
            jb = jla.normal_blocks_delta(jb, *(jnp.asarray(d[k]) for k in (
                "r_d", "J_d", "sigma_d", "U_d", "valid_d")))
            tb = tla.normal_blocks_delta(tb, *(_t(d[k]) for k in (
                "r_d", "J_d", "sigma_d", "U_d", "valid_d")))
        if fn == "normal_blocks_shift":
            jb = jla.normal_blocks_shift(jb, jnp.asarray(d["dpar"]))
            tb = tla.normal_blocks_shift(tb, _t(d["dpar"]))
        if fn.startswith("normal_solve"):
            jo = jla.normal_solve_from_blocks(jb, with_health=True)
            to = tla.normal_solve_from_blocks(tb, with_health=True)
            for a, b in zip(to[:4], jo[:4]):
                assert _rel(a.numpy(), b) <= lim
            assert int(to[4].n_truncated) == int(jo[4].n_truncated)
            return
        assert _blocks_rel(tb, jb) <= lim
        return
    rows = np.arange(40, 40 + len(d["sigma_d"]))
    if fn == "su_dense_rows":
        assert np.array_equal(tla.su_dense_rows(su_t, rows).numpy(),
                              np.asarray(jla.su_dense_rows(su_j, rows)))
        return
    if fn == "su_pad_rows":
        assert np.array_equal(
            tla.su_to_dense(tla.su_pad_rows(su_t, 5)).numpy(),
            np.asarray(jla.su_to_dense(jla.su_pad_rows(su_j, 5))))
        return
    gj = jla.noise_gram_precompute(jnp.asarray(sigma), su_j,
                                   jnp.asarray(phi))
    gt = tla.noise_gram_precompute(_t(sigma), su_t, _t(phi))
    u_old = dense[rows]
    if fn == "noise_gram_append":
        gj2 = jla.noise_gram_append(gj, 40, jnp.asarray(d["sigma_d"]),
                                    jnp.asarray(d["U_d"]),
                                    jnp.asarray(sigma[rows]),
                                    jnp.asarray(u_old))
        gt2 = tla.noise_gram_append(gt, _t(d["sigma_d"]), _t(d["U_d"]),
                                    _t(sigma[rows]), _t(u_old))
        assert _rel(gt2.numpy(), gj2) <= lim
        return
    # woodbury_pre_append, against a dense basis in both packages
    pj = jla.woodbury_precompute(jnp.asarray(sigma), jnp.asarray(dense),
                                 jnp.asarray(phi))
    pt = tla.woodbury_precompute(_t(sigma), _t(dense), _t(phi))
    pj2 = jla.woodbury_pre_append(pj, 40, jnp.asarray(d["sigma_d"]),
                                  jnp.asarray(d["U_d"]))
    pt2 = tla.woodbury_pre_append(pt, 40, _t(d["sigma_d"]), _t(d["U_d"]))
    for a, b in ((pt2.nvec, pj2.nvec), (pt2.U, pj2.U),
                 (pt2.chol_lower, pj2.chol_lower)):
        assert _rel(a.numpy(), b) <= lim
    assert abs(float(pt2.logdet) - float(pj2.logdet)) <= lim * abs(
        float(pj2.logdet))
    # the structured basis takes the same rows
    ps = tla.woodbury_pre_append(tla.woodbury_precompute(_t(sigma), su_t,
                                                         _t(phi)),
                                 40, _t(d["sigma_d"]), _t(d["U_d"]))
    assert _rel(tla.su_to_dense(ps.U).numpy(), pj2.U) == 0.0
    assert _rel(ps.chol_lower.numpy(), pj2.chol_lower) <= lim


# --------------------------------------------------------------------------
# kernel K10's plain version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,c,c0", [(300, 12, 4), (32, 40, 0), (77, 9, 0),
                                    (1, 5, 2), (33, 12, 0), (97, 12, 0),
                                    (2049, 9, 3), (113 * 96 + 1, 7, 2),
                                    (100, 120, 40)])
def test_stream_moments_plain_matches_numpy(n, c, c0):
    rng = np.random.default_rng(n + c)
    A = rng.standard_normal((n, c)) * 10.0 ** rng.uniform(-4, 4, c)
    w = rng.uniform(0.5, 2.0, n) * 1e12
    S0 = rng.standard_normal((c, c - c0))
    S = torch.tensor(S0)
    tla.stream_moments(S, torch.tensor(A), torch.tensor(w), c0)
    terms = (A * w[:, None]).T @ A[:, c0:]
    ref = S0 + terms
    abs_sum = np.abs(S0) + np.abs(A * w[:, None]).T @ np.abs(A[:, c0:])
    assert np.all(np.abs(S.numpy() - ref)
                  <= tol.stream_moments_limit(n, abs_sum))
    # in place on a strided view: the columns c0: of a (c, c) matrix
    full = torch.zeros((c, c), dtype=torch.float64)
    tla.stream_moments(full[:, c0:], torch.tensor(A), torch.tensor(w), c0)
    alone = torch.zeros((c, c - c0), dtype=torch.float64)
    tla.stream_moments(alone, torch.tensor(A), torch.tensor(w), c0)
    assert torch.equal(full[:, c0:], alone)
    assert torch.all(full[:, :c0] == 0)


@pytest.mark.parametrize("n", [1, 5, 31, 32, 33, 95])
def test_stream_moments_plain_one_split_as_its_full_rows(n):
    """One split (n < 96) sums its n rows alone: bit for bit the sum over
    all 96 rows of the split with the rest zero, as the kernel's split
    holds them, signs of zero included."""
    rng = np.random.default_rng(n)
    c, c0 = 9, 3
    A = rng.standard_normal((n, c)) * 10.0 ** rng.uniform(-4, 4, c)
    A[:, 1] = -0.0
    w = rng.uniform(0.5, 2.0, n) * 1e12
    S0 = rng.standard_normal((c, c - c0))
    S0[0] = -0.0
    pad = tla.K10_ROWS - n
    short = tla.stream_moments(torch.tensor(S0), torch.tensor(A),
                               torch.tensor(w), c0)
    full = tla.stream_moments(
        torch.tensor(S0), torch.tensor(np.r_[A, np.zeros((pad, c))]),
        torch.tensor(np.r_[w, np.zeros(pad)]), c0)
    assert torch.equal(short.view(torch.int64), full.view(torch.int64))


def test_k10_wrapper_takes_cpu_tensors_to_plain():
    S = torch.zeros((3, 3), dtype=torch.float64)
    A = torch.ones((4, 3), dtype=torch.float64)
    tla.K10.launches = 0
    tla.stream_moments(S, A, torch.ones(4, dtype=torch.float64))
    assert tla.K10.launches == 0 and float(S[0, 0]) == 4.0
    with pytest.raises(ValueError):
        tla.stream_moments_cuda(S, A, torch.ones(4, dtype=torch.float64))


# --------------------------------------------------------------------------
# the streams
# --------------------------------------------------------------------------

def _stream(jcls, tcls, par, base, nights, maxiter=5):
    """Run JAX's stream and the port's over the same TOAs; returns
    (JAX model, port model, port fitter, per-night rows)."""
    jm, tm = jget_model(par), get_model(par)
    jf = jcls(base[0], jm, bucket=True)
    tf = tcls(base[1], tm, bucket=True, device=CPU)
    jf.fit_toas(maxiter=maxiter)
    tf.fit_toas(maxiter=maxiter)
    jf.stream_prepare()
    tf.stream_prepare()
    from pint_tpu import telemetry

    rows = []
    for jn, tn in nights:
        c_j = telemetry.counter_get("stream.captures")
        c_t = tf.stream_counts["captures"]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rj = jf.append_refit(jn, maxiter=maxiter)
            rt = tf.append_refit(tn, maxiter=maxiter)
        free = list(tm.free_params)
        if rt["cond_log10"] is not None:
            lim = tol.stream_fit_tolerances(rt["cond_log10"],
                                            rt["centering"])
        else:  # a full fit: its own health
            cond = tf.fit_health["cond_log10"]
            lim = tol.fit_tolerances(tol.wls_normal_cond_log10(cond)
                                     if isinstance(tf, WLSFitter) else cond)
        rows.append({
            "jax": rj, "port": rt, "limits": lim,
            "captures": (telemetry.counter_get("stream.captures") - c_j,
                         tf.stream_counts["captures"] - c_t),
            "values": (np.array([jm.values[k] for k in free]),
                       np.array([tm.values[k] for k in free])),
            "unc": (np.array([jm.params[k].uncertainty for k in free]),
                    np.array([tm.uncertainties[k] for k in free]))})
    return jm, tm, tf, rows


def _scratch(tcls, par, tf, maxiter=5):
    """The port's own from-scratch fit over the data the stream holds."""
    m = get_model(par)
    f = tcls(tf.toas[np.arange(tf.toas.n_filled)], m, bucket=True,
             device=CPU)
    f.fit_toas(maxiter=maxiter)
    return m


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """Four streams run once: ``white`` (WLS, 105 TOAs in the 125
    bucket, 9 nights of 2 and a night of 2 with one row 50 us off: the
    recapture after the 8th refit, a quarantine), ``red`` (GLS red
    noise, 2 nights of 8), ``ecorr`` (GLS with 4 ECORR epochs, 2 nights
    of 4, a night of two TOAs 0.5 s apart that would form an epoch: the
    veto, a quarantine night of 4) and ``boundary`` (WLS, 120 TOAs, a
    16-TOA night that overflows the bucket, then a night of 8)."""
    tmp = tmp_path_factory.mktemp("streams")
    out = {}
    sim = jget_model(BASE_PAR + WHITE)
    base = _both(tmp, "white", _fake(sim, 105, 1))
    nights = [_both(tmp, f"w{i}", _night(sim, i, 2, 700 + i))
              for i in range(9)]
    q = _night(sim, 9, 2, 709)
    q.ticks = q.ticks.copy()
    q.ticks[1] += np.int64(round(50e-6 * 2**32))
    q._compute_posvels()
    nights.append(_both(tmp, "wq", q))
    out["white"] = (WLSFitter, BASE_PAR + WHITE) + _stream(
        JWLSFitter, WLSFitter, BASE_PAR + WHITE, base, nights)

    par = BASE_PAR + WHITE + RED
    sim = jget_model(par)
    base = _both(tmp, "red", _fake(sim, 105, 2))
    nights = [_both(tmp, f"r{i}", _night(sim, i, 8, 777 + i))
              for i in range(2)]
    out["red"] = (GLSFitter, par) + _stream(JGLSFitter, GLSFitter, par,
                                            base, nights)

    par = BASE_PAR + WHITE + ECORR
    sim = jget_model(par)
    parts = [_fake(sim, 95, 3)]
    for j in range(4):
        s0 = 53100.0 + 300.0 * j
        parts.append(jfake(s0, s0 + 5e-6, 3, sim, freq_mhz=1400.0,
                           obs="gbt", error_us=1.0, add_noise=True,
                           rng=np.random.default_rng(50 + j),
                           flags={"f": "fake"}))
    base = _both(tmp, "ecorr", JTOAs.merge(parts))
    nights = [_both(tmp, f"e{i}", _night(sim, i, 4, 880 + i))
              for i in range(2)]
    nights.append(_both(tmp, "eveto", _night(sim, 2, 2, 882,
                                             width=0.5 / 86400.0)))
    q = _night(sim, 3, 4, 883)
    q.ticks = q.ticks.copy()
    q.ticks[2] -= np.int64(round(50e-6 * 2**32))
    q._compute_posvels()
    nights.append(_both(tmp, "eq", q))
    out["ecorr"] = (GLSFitter, par) + _stream(JGLSFitter, GLSFitter, par,
                                              base, nights)

    sim = jget_model(BASE_PAR + WHITE)
    base = _both(tmp, "bound", _fake(sim, 120, 5))
    nights = [_both(tmp, "big", _night(sim, 0, 16, 950)),
              _both(tmp, "after", _night(sim, 3, 8, 951))]
    out["boundary"] = (WLSFitter, BASE_PAR + WHITE) + _stream(
        JWLSFitter, WLSFitter, BASE_PAR + WHITE, base, nights)
    return out


KINDS = ["white", "red", "ecorr", "boundary"]


@pytest.mark.parametrize("kind", KINDS)
def test_stream_decisions_match_jax(streams, kind):
    """Mode, in_bucket, verdict, quarantined rows and captures per
    night equal JAX's."""
    rows = streams[kind][-1]
    for row in rows:
        rj, rt = row["jax"], row["port"]
        assert rt["mode"] == rj["mode"]
        assert rt["in_bucket"] == rj["in_bucket"]
        assert rt["triage"]["verdict"] == rj["triage"]["verdict"]
        assert np.array_equal(rt["triage"]["quarantine"],
                              rj["triage"]["quarantine"])
        assert row["captures"][0] == row["captures"][1]
    modes = [r["port"]["mode"] for r in rows]
    verdicts = [r["port"]["triage"]["verdict"] for r in rows]
    want = {"white": (["incremental"] * 10, ["clean"] * 9 + ["outlier"]),
            "red": (["incremental"] * 2, ["clean"] * 2),
            "ecorr": (["incremental", "incremental", "reprepare",
                       "incremental"], ["clean"] * 3 + ["outlier"]),
            "boundary": (["reprepare", "incremental"], ["clean"] * 2)}
    assert (modes, verdicts) == want[kind]


@pytest.mark.parametrize("kind", KINDS)
def test_stream_refits_match_jax(streams, kind):
    """chi^2 per night within the stream limit; values and
    uncertainties within the fit limits of the refit's condition
    number (the incremental nights), or of the full fit's."""
    for row in streams[kind][-1]:
        rj, rt = row["jax"], row["port"]
        lim = row["limits"]
        assert abs(rt["chi2"] / rj["chi2"] - 1.0) <= max(
            tol.stream_chi2_limit(), lim["chi2_rel"])
        jv, tv = row["values"]
        ju, tu = row["unc"]
        assert np.max(np.abs(tv - jv) / ju) <= lim["values_sigma"]
        assert np.max(np.abs(tu / ju - 1.0)) <= lim["unc_rel"]


@pytest.mark.parametrize("kind", KINDS)
def test_stream_matches_own_scratch_fit(streams, kind):
    """JAX's oracle (tests/test_stream.py:66-76): the streamed values
    within 0.05 sigma of a from-scratch fit over the merged data."""
    cls, par, _, tm, tf, _ = streams[kind]
    scratch = _scratch(cls, par, tf)
    for name in scratch.free_params:
        a, b = tm.values[name], scratch.values[name]
        err = scratch.uncertainties[name]
        assert abs(a - b) <= 0.05 * err + 1e-9 * max(abs(b), 1.0), name


def test_recapture_after_eighth_refit(streams):
    rows = streams["white"][-1]
    caps = [r["captures"][1] for r in rows]
    want = [0] * 10
    want[STREAM_RECAPTURE - 1] = 1
    assert caps == want == [r["captures"][0] for r in rows]


def test_ecorr_veto_and_quarantine(streams):
    """The night whose two TOAs are 0.5 s apart would form an epoch: the
    ECORR hook vetoes and both packages re-prepare; the quarantine
    night's off row is held out, the epochs formed in the base kept."""
    _, _, _, _, tf, rows = streams["ecorr"]
    assert rows[2]["port"]["mode"] == rows[2]["jax"]["mode"] == "reprepare"
    assert rows[3]["port"]["triage"]["quarantine"].tolist() == [2]
    assert sum(tf.prepared.ctx["EcorrNoise"]["counts"]) >= 4
    assert tf.toas.pad_valid is not None \
        and not tf.toas.pad_valid[tf.toas.n_filled - 2]


def test_steady_state_append_has_no_full_pass(tmp_path, monkeypatch):
    """The invariant behind tests/test_stream.py's TestZeroRecompile: a
    steady-state append captures nothing and prepares nothing the size
    of the dataset (only the 32-row mini dataset)."""
    sim = jget_model(BASE_PAR + WHITE)
    _, base = _both(tmp_path, "b", _fake(sim, 105, 4))
    nights = [_both(tmp_path, f"n{i}", _night(sim, i, 6, 900 + i))[1]
              for i in range(3)]
    f = WLSFitter(base, get_model(BASE_PAR + WHITE), bucket=True,
                  device=CPU)
    f.fit_toas(maxiter=3)
    f.stream_prepare()
    f.append_refit(nights[0], maxiter=3)
    sizes = []
    init = ttm.PreparedModel.__init__

    def spy(self, model, toas, tzr, device):
        sizes.append(len(toas))
        init(self, model, toas, tzr, device)

    monkeypatch.setattr(ttm.PreparedModel, "__init__", spy)
    caps = f.stream_counts["captures"]
    for d in nights[1:]:
        assert f.append_refit(d, maxiter=3)["mode"] == "incremental"
    assert f.stream_counts["captures"] == caps
    assert sizes == [32, 32]
