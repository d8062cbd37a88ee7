"""The port's dense common-red-noise path (``CommonProcess(kron=False)``,
K11's plain version ``crn_capacity_plain``) and ``kron_gram_append``
against pint_tpu at small size, on the CPU.

Two arrays from fixed seeds (``pint_tpu.simulation``), carried across as
plain arrays (``tools/export_torch_pta_case.pta_case_arrays`` ->
``convert.pta_case_from_arrays``): a ragged one (two pulsars of 40
TOAs, two of 30, one of 35 without red noise) and a square 4 x 40 one,
each with a GWB over 3 common modes.  Each is built once per package
and shared by every ORF through ``_prebuilt``.  Tolerances
(``pint_tpu_torch/tolerances.py``):

- ``lnlike`` / ``lnlike_grid`` against pint_tpu's ``kron=False`` and
  against the port's own kron path: ``GW_LNLIKE_REL`` (1e-10, the
  reference's kron == dense pin) under Hellings-Downs,
  ``GW_SINGULAR_REL`` (2e-5, the reference's pin for them) under the
  rank-deficient monopole and dipole ORFs;
- the capacity matrices and logdet phi against the reference's
  ``_phi_terms`` 2-D branch plus the gram: ``crn_capacity_limit`` of
  the ORF blocks' condition number;
- the gram G0 and b against the reference's, and ``kron_gram_append``
  against the reference's and a regram of the extended stack: 1e-12 of
  each entry's sum of |terms|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu import linalg as jlinalg
from pint_tpu.gw import CommonProcess as JCommonProcess
from pint_tpu.gw.common import build_pulsar_data as jbuild
from pint_tpu.gw.common import gwb_phi as jgwb_phi
from pint_tpu.simulation import add_gwb, make_fake_pta
from pint_tpu_torch import tolerances as tol
from pint_tpu_torch.convert import pta_case_from_arrays
from pint_tpu_torch.fitter import FitDivergedError
from pint_tpu_torch.gw import common as tgw_common
from pint_tpu_torch.gw.common import CommonProcess, build_pulsar_data
from pint_tpu_torch.gw.hmc import GWBPosterior
from pint_tpu_torch.linalg import (KronGram, _gram_split,
                                   crn_capacity_cuda, crn_capacity_plain,
                                   kron_gram_append, kron_gram_plain,
                                   kron_gram_precompute, ragged_stack)
from tools.export_torch_pta_case import pta_case_arrays

# one intra-op thread: the tests run at small sizes, and pytest-xdist's
# workers share the machine's cores (torch's default of one thread per
# core in every worker oversubscribes them several times over)
torch.set_num_threads(1)

NMODES = 3
RED = "TNRedAmp -13.5\nTNRedGam 4.0\nTNRedC 6\n"
POINTS = ((-14.0, 13 / 3), (-13.2, 3.0), (-15.5, 5.5))
CPU = "cpu"
#: 1e-12 of sum |terms|: the same products summed in other orders
SUM_REL = 1e-12


def _ragged():
    kw = dict(duration_days=3000.0)
    return (make_fake_pta(2, 40, seed=1, extra_par=RED, name_prefix="A",
                          **kw)
            + make_fake_pta(3, 30, seed=2, extra_par=RED, name_prefix="B",
                            **kw)[1:]
            + make_fake_pta(4, 35, seed=3, name_prefix="C", **kw)[3:4])


def _square():
    return make_fake_pta(4, 40, seed=5, extra_par=RED, duration_days=3000.0)


@pytest.fixture(scope="module", params=["ragged", "square"])
def built(request):
    """(name, JAX data, port data, port pairs) of one array: the build
    tuples both packages' ``_prebuilt`` take, and the pairs they came
    from."""
    pairs = {"ragged": _ragged, "square": _square}[request.param]()
    add_gwb([t for _, t in pairs], [m for m, _ in pairs], 5e-14, rng=7,
            nmodes=NMODES)
    jd = jbuild(pairs, nmodes=NMODES)[:4]
    tp = pta_case_from_arrays(pta_case_arrays(pairs))
    td = build_pulsar_data(tp, nmodes=NMODES, device=CPU)[:4]
    return request.param, jd, td, tp


def _pair(built, orf, kron=False):
    _, jd, td, _ = built
    j = JCommonProcess(nmodes=NMODES, orf=orf, kron=kron, _prebuilt=jd)
    t = CommonProcess(nmodes=NMODES, orf=orf, kron=kron, device=CPU,
                      _prebuilt=td + (None,))
    return j, t


def _orfs(built):
    # the singular ORFs on the square array only
    return ["hd"] if built[0] == "ragged" else ["hd", "monopole", "dipole"]


def _limit(orf):
    return tol.GW_LNLIKE_REL if orf == "hd" else tol.GW_SINGULAR_REL


def test_lnlike_vs_jax(built):
    for orf in _orfs(built):
        jcrn, tcrn = _pair(built, orf)
        for la, g in POINTS:
            assert abs(tcrn.lnlike(la, g) / jcrn.lnlike(la, g) - 1) \
                <= _limit(orf), (orf, la, g)


def test_lnlike_grid_vs_jax_and_chunked(built, monkeypatch):
    amps, gams = np.linspace(-15.0, -13.5, 3), np.linspace(2.0, 6.0, 2)
    for orf in _orfs(built):
        jcrn, tcrn = _pair(built, orf)
        ref = jcrn.lnlike_grid(amps, gams)
        got = tcrn.lnlike_grid(amps, gams)
        assert got.shape == (3, 2)
        assert np.max(np.abs(got / ref - 1)) <= _limit(orf), orf
        with monkeypatch.context() as m:
            m.setattr(tgw_common, "GRID_MEM_BYTES", 1)
            assert tcrn.grid_chunk() == 1
            assert np.array_equal(tcrn.lnlike_grid(amps, gams), got)


def test_dense_equals_kron(built):
    for orf in _orfs(built):
        _, dense = _pair(built, orf)
        _, kron = _pair(built, orf, kron=True)
        for la, g in POINTS:
            assert abs(dense.lnlike(la, g) / kron.lnlike(la, g) - 1) \
                <= _limit(orf), (orf, la, g)


def test_paths_build_lazily_and_u_full(built):
    """A dense instance builds no kron stacks, a kron one no U_full; the
    dense basis is the reference's within 1e-12 of each column's largest
    entry (the timing-design columns come from two jacfwds)."""
    jcrn, dense = _pair(built, "hd")
    _, kron = _pair(built, "hd", kron=True)
    dense.lnlike(-14.0, 4.0)
    kron.lnlike(-14.0, 4.0)
    assert dense._kron_data is None and kron._U_full is None
    U, ref = dense.U_full.numpy(), np.asarray(jcrn.U_full)
    assert np.all(np.abs(U - ref) <= 1e-12 * np.max(np.abs(ref), axis=0))
    assert np.array_equal(U == 0.0, ref == 0.0)
    k = dense.U_full.shape[1]
    assert dense.grid_chunk() == max(
        1, tgw_common.GRID_MEM_BYTES // (3 * k * k * 8))


def test_dense_data_vs_jax(built):
    jcrn, tcrn = _pair(built, "hd")
    U = np.asarray(jcrn.U_full)
    w = 1.0 / np.asarray(jcrn.sigma) ** 2
    ninv_r = np.asarray(jcrn.r) * w
    ref_gram = np.asarray(jlinalg._weighted_gram(jnp.asarray(U),
                                                 jnp.asarray(w)))
    dd = tcrn.dense
    abs_gram = (np.abs(U).T * w) @ np.abs(U)
    assert np.all(np.abs(dd.gram.numpy() - ref_gram) <= SUM_REL * abs_gram)
    assert np.all(np.abs(dd.b.numpy() - U.T @ ninv_r)
                  <= SUM_REL * (np.abs(U).T @ np.abs(ninv_r)))
    assert abs(float(dd.rr) / float(np.sum(np.asarray(jcrn.r) * ninv_r))
               - 1) <= SUM_REL


def _jax_capacity(jcrn, la, g):
    """The reference's S and logdet phi at one point: the dense prior of
    gw/common.py:194-200 through linalg._phi_terms, plus the gram."""
    phi_gw = jgwb_phi(jcrn.freqs, 10.0**la, g, jcrn.df)
    kn = jcrn.phi_noise.shape[0]
    k = jcrn.U_full.shape[1]
    phi = jnp.zeros((k, k))
    phi = phi.at[:kn, :kn].set(jnp.diag(jcrn.phi_noise))
    phi = phi.at[kn:, kn:].set(jnp.kron(jcrn.orf, jnp.diag(phi_gw)))
    phi_inv, ld = jlinalg._phi_terms(phi)
    gram = jlinalg._weighted_gram(jcrn.U_full, 1.0 / jcrn.sigma**2)
    return (np.asarray(gram + phi_inv), float(ld), np.asarray(phi_gw),
            np.asarray(gram))


def test_crn_capacity_plain_vs_jax(built):
    for orf, (la, g) in [(o, pt) for o in _orfs(built)[:2]
                         for pt in POINTS[:2]]:
        jcrn, tcrn = _pair(built, orf)
        dd = tcrn.dense
        S_ref, ld_ref, phi_gw, gram = _jax_capacity(jcrn, la, g)
        S, ld = crn_capacity_plain(torch.tensor(gram), dd.phi_noise,
                                   dd.orf, torch.tensor(phi_gw)[None])
        orf_m = dd.orf.numpy()
        lim = tol.crn_capacity_limit(
            orf_m.shape[0], tol.crn_block_kappa(orf_m, phi_gw))
        assert np.max(np.abs(S[0].numpy() - S_ref)) \
            <= lim * np.max(np.abs(S_ref)), (orf, la, g)
        assert abs(float(ld[0]) - ld_ref) \
            <= lim * (S_ref.shape[0] + abs(ld_ref)), (orf, la, g)


def test_non_finite_is_reported(built):
    _, tcrn = _pair(built, "hd")
    with pytest.raises(FitDivergedError):
        tcrn.lnlike(np.nan, 4.0)
    assert np.isnan(tcrn.lnlike(np.nan, 4.0, check=False))
    with pytest.warns(UserWarning, match="1/2 non-finite"):
        surf = tcrn.lnlike_grid([-14.0], [4.0, np.nan])
    assert np.isfinite(surf[0, 0]) and np.isnan(surf[0, 1])


def test_posterior_on_dense_raises(built):
    """A posterior over a dense process built from pairs samples what the
    kron one does; over a ``_prebuilt`` process (no prepared models) it
    raises."""
    tp = built[3]
    dense = GWBPosterior(CommonProcess(tp, nmodes=NMODES, kron=False,
                                       device=CPU))
    kron = GWBPosterior(CommonProcess(tp, nmodes=NMODES, device=CPU))
    assert dense.param_names == kron.param_names
    assert np.array_equal(dense.bounds, kron.bounds)
    assert np.array_equal(dense.scales, kron.scales)
    _, tcrn = _pair(built, "hd")
    with pytest.raises(ValueError, match="_prebuilt"):
        GWBPosterior(tcrn)


def test_kron_none_takes_the_kron_path(monkeypatch):
    """``kron=None`` is the reference's default gate, which takes the
    kron path while ``$PINT_TPU_KRON_PHI`` is unset: the port takes it
    too, with the same likelihood, and a posterior builds over it."""
    monkeypatch.delenv("PINT_TPU_KRON_PHI", raising=False)
    jpairs = _square()
    add_gwb([t for _, t in jpairs], [m for m, _ in jpairs], 5e-14, rng=7,
            nmodes=NMODES)
    tpairs = pta_case_from_arrays(pta_case_arrays(jpairs))
    jcrn = JCommonProcess(jpairs, nmodes=NMODES, kron=None)
    tcrn = CommonProcess(tpairs, nmodes=NMODES, kron=None, device=CPU)
    assert jcrn._kron is True and tcrn.kron is True
    for la, g in POINTS:
        assert abs(tcrn.lnlike(la, g) / jcrn.lnlike(la, g) - 1) \
            <= tol.GW_LNLIKE_REL, (la, g)
    assert GWBPosterior(tcrn).ndim == 2 + 2 * len(tpairs)


def test_crn_capacity_cuda_refuses_cpu_tensors():
    f64 = dict(dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        crn_capacity_cuda(torch.eye(5, **f64), torch.ones(1, **f64),
                          torch.eye(2, **f64), torch.ones((1, 2), **f64))


def _stack(data, cut=None):
    """The ragged stack of ``data``, pulsar ``cut[0]`` cut to its first
    ``cut[1]`` rows."""
    rs, ss, us, fs = [], [], [], []
    for a, d in enumerate(data):
        n = cut[1] if cut and a == cut[0] else len(d.r)
        rs.append(d.r[:n])
        ss.append(d.sigma[:n])
        us.append(d.U[:n])
        fs.append(d.F[:n])
    return ragged_stack(rs, ss, us, fs, CPU)


def test_kron_gram_append(built):
    """Rows appended to one pulsar by kron_gram_append equal a regram of
    the extended stack and pint_tpu's append."""
    _, _, td, _ = built
    data = td[0]
    a, n_new = 1, 7
    d = data[a]
    n0 = len(d.r) - n_new
    pre = kron_gram_precompute(_stack(data, (a, n0)))
    nb_max = pre.g_uu.shape[-1]
    u_rows = np.zeros((n_new, nb_max))
    u_rows[:, :d.U.shape[1]] = d.U[n0:]
    rows = [torch.tensor(x) for x in (d.r[n0:], d.sigma[n0:], u_rows,
                                      d.F[n0:])]
    got = kron_gram_append(pre, a, n0, *rows)
    full = kron_gram_precompute(_stack(data))
    # each entry's sum of |terms|: the gram of |[U | F | r]|
    gabs, _ = kron_gram_plain(ragged_stack(
        [np.abs(x.r) for x in data], [x.sigma for x in data],
        [np.abs(x.U) for x in data], [np.abs(x.F) for x in data], CPU))
    ld_abs = torch.tensor([np.sum(np.abs(np.log(x.sigma**2)))
                           for x in data])
    abs_gram = _gram_split(gabs, ld_abs, pre.g_uu.shape[-1])
    jgot = jlinalg.kron_gram_append(
        jlinalg.KronGram(*[jnp.asarray(t.numpy()) for t in pre]), a, n0,
        *[jnp.asarray(t.numpy()) for t in rows])
    for name, g, f, j, s in zip(KronGram._fields, got, full, jgot,
                                abs_gram):
        g, f, s = g.numpy(), f.numpy(), s.numpy()
        assert np.all(np.abs(g - f) <= SUM_REL * s), name
        assert np.all(np.abs(g - np.asarray(j)) <= SUM_REL * s), name
    # every other pulsar's blocks untouched
    others = [b for b in range(len(data)) if b != a]
    for g, p in zip(got, pre):
        assert torch.equal(g[others], p[others])
