"""The port's PTA batch (``pint_tpu_torch.parallel.PTABatch``) against
pint_tpu's ``PTABatch`` at small size, on the CPU.

One heterogeneous array made with numpy from fixed seeds by
``pint_tpu.simulation``, 4 pulsars at gbt with ragged TOA counts
(40 + 10 i), EFAC/EQUAD/ECORR on ``-f L-wide`` and 6-mode red noise,
F0 moved by 2e-11 Hz so that the fits have work:

- 0: isolated, 40 uniform TOAs (no ECORR epoch);
- 1: DD (ECC 0.17), 25 epochs of 2 TOAs 2e-6 d apart (ECORR epochs);
- 2: isolated, 20 epochs of 3 TOAs and no red noise (the superset adds
  it inert): U's width differs from member 1's;
- 3: DD, 70 uniform TOAs.

It goes through pint_tpu and, carried across as plain arrays
(``tools/export_torch_pta_case.pta_case_arrays`` ->
``convert.pta_case_from_arrays``), through the port with
``device="cpu"`` (the kernels' plain versions); one JAX program per fit
kind, in module fixtures.  Limits (``pint_tpu_torch/tolerances.py``):
residuals 1e-11 s; ``chisq`` ``pta_chi2_limit``; fitted values, sigma
and chi^2 of the free entries ``fit_tolerances`` of each member's
condition (from the port's single-pulsar fit of it; values less one ulp,
``values_sigma_ulp``; chi^2 plus ``pta_chi2_limit``); against the port's
single-pulsar fitters the reference's pins (tests/test_pta.py:221-263):
F0 within 5e-10 Hz, chi^2 within 1e-8 relative.
"""

import copy

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pint_tpu.models.builder import get_model as jget_model
from pint_tpu.parallel.pta import PTABatch as JPTABatch
from chip_smoke import pta_single_fit
from pint_tpu.simulation import (make_fake_toas_fromMJDs,
                                 make_fake_toas_uniform)
from pint_tpu_torch import fixedpoint as tfp
from pint_tpu_torch import linalg as tl
from pint_tpu_torch import tolerances as tol
from pint_tpu_torch.convert import pta_case_from_arrays
from pint_tpu_torch.fitter import FitDivergedError
from pint_tpu_torch.models.binary.kepler import newton_iters_for
from pint_tpu_torch.parallel import PTABatch
from pint_tpu_torch.residuals import Residuals
from tools.export_torch_pta_case import pta_case_arrays

# one intra-op thread: the tests run at small sizes, and pytest-xdist's
# workers share the machine's cores (torch's default of one thread per
# core in every worker oversubscribes them several times over)
torch.set_num_threads(1)

CPU = "cpu"
MAXITER = 3
DD = "BINARY DD\nPB 8.3 1\nA1 6.1 1\nT0 54500.2 1\nECC 0.17 1\nOM 110.0 1\n"
WHITE = "EFAC -f L-wide 1.1\nEQUAD -f L-wide 0.4\nECORR -f L-wide 0.6\n"
RED = "TNRedAmp -13.0\nTNRedGam 3.0\nTNRedC 6\n"
#: (binary, red noise, epoch size: 0 for uniform TOAs) of each member
MEMBERS = ((False, True, 0), (True, True, 2), (False, False, 3),
           (True, True, 0))
PLACEHOLDERS = ("PB", "A1", "T0", "ECC", "OM")


def _par(i, binary, red):
    f0 = 100.0 + 37.0 * i + 0.123456789
    return (f"PSR FAKE{i:02d}\nRAJ {5 + 3 * i:02d}:10:00\n"
            f"DECJ {(i * 7) % 60 - 30:+03d}:00:00\nF0 {f0!r} 1\n"
            f"F1 -1e-15 1\nPEPOCH 54500\nDM {10 + i * 0.5} 1\n"
            "TZRMJD 54500\nTZRSITE @\nTZRFRQ 1400\nUNITS TDB\n"
            "EPHEM builtin\n") + (DD if binary else "") + WHITE \
        + (RED if red else "")


def _make_jpairs():
    pairs = []
    for i, (binary, red, epoch) in enumerate(MEMBERS):
        m = jget_model(_par(i, binary, red))
        n = 40 + 10 * i
        kw = dict(obs="gbt", error_us=1.0, add_noise=True,
                  rng=np.random.default_rng(20 + i),
                  freq_mhz=np.where(np.arange(n) % 2 == 0, 1400.0, 800.0),
                  flags={"f": "L-wide"})
        if epoch:
            mjds = np.concatenate([53000.0 + 60.0 * d
                                   + np.arange(epoch) * 2e-6
                                   for d in range(n // epoch)])
            t = make_fake_toas_fromMJDs(mjds, m, **kw)
        else:
            t = make_fake_toas_uniform(53000, 56000, n, m, **kw)
        m.values["F0"] += 2e-11
        pairs.append((m, t))
    return pairs


@pytest.fixture(scope="module")
def jpairs():
    return _make_jpairs()


@pytest.fixture(scope="module")
def arrays(jpairs):
    return pta_case_arrays(jpairs)


def _tpairs(arrays):
    """The port's (model, table, tzr) triples, fresh copies."""
    return pta_case_from_arrays(arrays)


@pytest.fixture(scope="module")
def jax_answers(jpairs):
    """pint_tpu's answers from one batch over the array (its superset
    models are copies, and every fit starts from its ``values0``)."""
    out = {}
    b = JPTABatch(jpairs)
    out["free_names"] = list(b.free_names)
    out["residuals"] = np.asarray(b.residuals_shared())
    out["chisq"] = np.asarray(b.chisq())
    for kind in ("wls", "gls"):
        vec, chi2, cov = getattr(b, f"fit_{kind}")(maxiter=MAXITER)
        out[kind] = (np.asarray(vec), np.asarray(chi2), np.asarray(cov))
        out[f"{kind}_rung"] = b.fit_rung
    return out


@pytest.fixture(scope="module")
def port(arrays):
    """The port's answers from one batch over the array, as the
    reference's fixture takes them (every fit starts from ``values0``),
    and what each fit wrote back.  vmap's per-member fallback is
    switched off, so an op without a batching rule raises here (one
    that loops inside its rule shows in
    ``test_plain_kernel_calls_do_not_grow_with_pulsars``)."""
    out = {}
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        b = PTABatch(_tpairs(arrays), device=CPU)
        out["batch"] = b
        out["residuals"] = b.residuals().numpy()
        out["chisq"] = b.chisq()
        out["sigma"], out["cinv_r"] = b._sigma_cinv_r("wls")
        for kind in ("wls", "gls"):
            vec, chi2, cov = getattr(b, f"fit_{kind}")(maxiter=MAXITER)
            out[kind] = (vec.numpy(), chi2.numpy(), cov.numpy())
            out[f"{kind}_written"] = [dict(p.model.values)
                                      for p in b.prepareds]
            out[f"{kind}_cinv_r"] = b._sigma_cinv_r(kind, vec)[1]
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(True)
    return out


@pytest.fixture(scope="module")
def singles(arrays):
    """The port's single-pulsar WLS and GLS fits of every member (its own
    model, no superset), the rows ``chip_smoke.pta_single_fit`` gives:
    values, chi^2 at them (white for WLS, as the batch's WLS chi^2) and
    the solve's condition."""
    return {kind: [pta_single_fit(kind, model, toas, tzr, CPU,
                                  maxiter=MAXITER)[1]
                   for model, toas, tzr in _tpairs(arrays)]
            for kind in ("wls", "gls")}


def test_array_is_heterogeneous(port, jax_answers):
    b = port["batch"]
    assert b.free_names == jax_answers["free_names"]
    assert b.free_names == ["DM", "F0", "F1", "PB", "T0", "A1", "ECC",
                            "OM"]
    assert b.n_toas.tolist() == [40, 50, 60, 70] and b.n_max == 70
    # the superset: every member carries BinaryDD and PLRedNoise, the
    # added ones inert
    assert [p.model._superset_inert for p in b.prepareds] == [
        {"BinaryDD"}, set(), {"BinaryDD", "PLRedNoise"}, set()]
    dims = [r.prepared.noise_dimensions() for r in b.resids]
    assert [d.get("EcorrNoise", (0, 0))[1] for d in dims] == [0, 25, 20, 0]
    # the added red noise takes the default 30 modes (its TNREDC is 0)
    assert [d["PLRedNoise"][1] for d in dims] == [12, 12, 60, 12]
    U, phi = b._gather_noise()
    assert U.shape == (4, 70, 81) and phi.shape == (4, 81)
    # the superset-added red noise is inert: its weights sit at the floor
    red = b.resids[2].prepared.noise_dimensions()["PLRedNoise"]
    assert float(phi[2, red[0]:red[0] + red[1]].max()) < 1e-30


def test_residuals_match_jax(port, jax_answers):
    r, ref = port["residuals"], jax_answers["residuals"]
    assert r.shape == ref.shape
    assert np.max(np.abs(r - ref)) <= tol.PREFIT_S
    valid = port["batch"].valid.numpy()
    assert np.all(r[~valid] == 0.0)
    # the shared-program form returns the same bits as numpy
    np.testing.assert_array_equal(port["batch"].residuals_shared(), r)


def test_chisq_matches_jax(port, jax_answers):
    b = port["batch"]
    lim = tol.pta_chi2_limit(port["cinv_r"], port["sigma"], b.valid.numpy())
    assert np.all(np.abs(port["chisq"] - jax_answers["chisq"]) <= lim)


@pytest.mark.parametrize("kind", ["wls", "gls"])
def test_fit_matches_jax(port, jax_answers, singles, kind):
    """Fitted values, sigma and chi^2 of every member's free entries
    within fit_tolerances of the member's condition, the chi^2 beside
    it within what the residuals' disagreement allows
    (``pta_chi2_limit``); the pinned entries are the reference's noise
    in both (a zero column's eigenvalue sits at the cutoff: ROADMAP
    watch list) and are never written back."""
    vec, chi2, cov = port[kind]
    jvec, jchi2, jcov = jax_answers[kind]
    assert jax_answers[f"{kind}_rung"] == "baseline"
    mask = port["batch"].free_mask.numpy() > 0
    resid_lim = tol.pta_chi2_limit(port[f"{kind}_cinv_r"], port["sigma"],
                                   port["batch"].valid.numpy())
    for k in range(len(vec)):
        lim = tol.fit_tolerances(singles[kind][k]["cond_log10"])
        lim["chi2_abs"] = lim.pop("chi2_rel") * abs(jchi2[k]) + resid_lim[k]
        f = mask[k]
        jsig = np.sqrt(np.diag(jcov[k]))[f]
        sig = np.sqrt(np.diag(cov[k]))[f]
        got = {"values_sigma": tol.values_sigma_ulp(vec[k][f], jvec[k][f],
                                                    jsig),
               "unc_rel": np.max(np.abs(sig / jsig - 1.0)),
               "chi2_abs": abs(chi2[k] - jchi2[k])}
        bad = {n: (v, lim[n]) for n, v in got.items() if not v <= lim[n]}
        assert not bad, (kind, k, bad)


@pytest.mark.parametrize("kind", ["wls", "gls"])
def test_fit_matches_single_fitters(port, singles, kind):
    """The reference's pins against per-pulsar fits of the same members
    (tests/test_pta.py:221-263), and the written-back values."""
    vec, chi2, _ = port[kind]
    b = port["batch"]
    i_f0 = b.free_names.index("F0")
    for k, row in enumerate(singles[kind]):
        assert abs(vec[k, i_f0] - row["values"]["F0"]) <= 5e-10
        assert abs(chi2[k] / row["chi2"] - 1.0) <= 1e-8, (k, kind)
        written = port[f"{kind}_written"][k]
        for i, name in enumerate(b.free_names):
            if name in b.prepareds[k].model.free_params:
                assert written[name] == float(vec[k, i])


def test_placeholders_stay(port, arrays):
    """The isolated members' superset binary parameters keep their
    placeholder values through both fits."""
    b = port["batch"]
    for kind in ("wls", "gls"):
        for k in (0, 2):
            values = port[f"{kind}_written"][k]
            assert values["PB"] == 365.25 and values["T0"] == 0.0
            assert all(values[p] == 0.0 for p in ("A1", "ECC", "OM"))
            assert not set(PLACEHOLDERS) & set(
                b.prepareds[k].model.free_params)


def test_kepler_depth_harmonized(port):
    """The stacked fold closes over one Newton depth: the members' own
    classes (e = 0 and 0.17) deepen to the batch's largest."""
    b = port["batch"]
    assert b.static_ctx["BinaryDD"]["kepler_iters"] == newton_iters_for(0.17)
    assert all(p.ctx["BinaryDD"]["kepler_iters"] == newton_iters_for(0.17)
               for p in b.prepareds)


def test_gate_leaves_ungated_models_bit_identical(arrays):
    """A model with every gate 1 gives the residuals and the analytic
    design of the ungated model bit for bit; a DD member with its binary
    gated off gives the residuals of the same pulsar without the binary,
    bit for bit."""
    model, toas, tzr = _tpairs(arrays)[1]
    plain = Residuals(toas, model, tzr=tzr, device=CPU)
    gated_model = copy.deepcopy(model)
    gated_model._superset_inert = set()
    gated = Residuals(toas, gated_model, tzr=tzr, device=CPU)
    assert all("__gate__" in c for c in gated.prepared.ctx.values())
    v = plain.prepared.values_dict()
    bits = [lambda r: r.time_resids_at(v),
            lambda r: r.linear_design_at(v, ("F1", "DM"))]
    for f in bits:
        a, g = f(plain), f(gated)
        assert torch.equal(a.view(torch.int64), g.view(torch.int64))
    off = copy.deepcopy(model)
    off._superset_inert = {"BinaryDD"}
    iso = copy.deepcopy(model)
    iso.components = [c for c in iso.components
                      if type(c).__name__ != "BinaryDD"]
    a = Residuals(toas, off, tzr=tzr, device=CPU).time_resids_at(v)
    b = Residuals(toas, iso, tzr=tzr, device=CPU).time_resids_at(v)
    assert torch.equal(a.view(torch.int64), b.view(torch.int64))


def test_from_prepared_repeats_the_batch(port):
    """A batch rebuilt from the prepared members starts from their
    written-back values and evaluates as the original does there."""
    b = port["batch"]
    again = PTABatch.from_prepared(b.prepareds, b.resids)
    assert again.free_names == b.free_names
    # free entries as the GLS fit wrote them, pinned ones as they were
    written = np.where(b.free_mask.numpy() > 0, port["gls"][0],
                       b.values0.numpy())
    np.testing.assert_array_equal(again.values0.numpy(), written)
    np.testing.assert_array_equal(again.residuals().numpy(),
                                  b.residuals(again.values0).numpy())


def test_from_prepared_rejects_mixed_structure(arrays):
    """Prepared members of different component structure (an isolated
    one beside a DD one) raise, in either order: the superset alignment
    runs only from (model, toas) pairs."""
    tp = _tpairs(arrays)
    rs = [Residuals(toas, model, tzr=tzr, device=CPU)
          for model, toas, tzr in (tp[0], tp[1])]
    for order in (rs, rs[::-1]):
        with pytest.raises(ValueError, match="component structures"):
            PTABatch.from_prepared([r.prepared for r in order], order)


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def wrapped(*a):
        calls.append(1)
        return orig(*a)

    monkeypatch.setattr(module, name, wrapped)
    return calls


class _CountOps(TorchDispatchMode):
    """Counts the ATen ops dispatched under it (after vmap's batching,
    so a batched op is one call however many members it carries)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["wls", "gls"])
def test_plain_kernel_calls_do_not_grow_with_pulsars(arrays, monkeypatch,
                                                     kind):
    """Each batched fit calls K1's and K7's plain versions as often for
    4 members as for 2 (one launch each on the card), and the batch
    path never reaches K2's or K8's: U is densified.  A second call
    dispatches as many ATen ops for 4 members as for 2: nothing in the
    port's own code runs once per member (the GLS weights are reused at
    unchanged noise values)."""
    spies = {"K1": _spy(monkeypatch, tfp, "phase_f0_t_plain"),
             "K7": _spy(monkeypatch, tl, "wls_whiten_plain"),
             "K2": _spy(monkeypatch, tl, "segment_sum_plain"),
             "K8": _spy(monkeypatch, tl, "woodbury_chi2_pre_plain")}
    counts, ops = [], []
    for members in ([0, 1, 2, 3], [0, 1]):
        tp = _tpairs(arrays)
        b = PTABatch([tp[i] for i in members], device=CPU)
        before = {n: len(c) for n, c in spies.items()}
        getattr(b, f"fit_{kind}")(maxiter=2)
        counts.append({n: len(c) - before[n] for n, c in spies.items()})
        with _CountOps() as mode:
            getattr(b, f"fit_{kind}")(maxiter=2)
        ops.append(mode.n)
    assert counts[0] == counts[1]
    assert counts[0]["K1"] > 0 and counts[0]["K2"] == counts[0]["K8"] == 0
    assert (counts[0]["K7"] > 0) == (kind == "wls")
    assert ops[0] == ops[1] > 0


def test_diverged_member_is_not_written_back(arrays):
    b = PTABatch(_tpairs(arrays), device=CPU)
    i_dm = b.free_names.index("DM")
    start = [dict(p.model.values) for p in b.prepareds]
    b.values0[1, i_dm] = float("nan")
    with pytest.raises(FitDivergedError, match=r"members \[1\]"):
        b.fit_wls(maxiter=1)
    assert b.prepareds[1].model.values == start[1]
    for k in (0, 2, 3):
        assert b.prepareds[k].model.values["DM"] != start[k]["DM"]


def test_homogeneous_batch_takes_no_superset(arrays):
    """Members of one structure (the two DD members with red noise) are
    batched as they are: no superset copy, no gate."""
    tp = _tpairs(arrays)
    b = PTABatch([tp[1], tp[3]], device=CPU)
    assert not any(hasattr(p.model, "_superset_inert") for p in b.prepareds)
    assert not any("__gate__" in c for p in b.prepareds
                   for c in p.ctx.values())


def test_entry_point_defaults_to_cuda(arrays, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PTABatch(_tpairs(arrays))
