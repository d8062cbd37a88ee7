"""The port's GLS slice against pint_tpu at small size.

One dataset, made with numpy from seed 0 by ``tools/export_torch_case``:
the B1855-like DD model (bench.py's par) observed at 10 epochs x 20
sub-band channels x 2 receivers = 400 TOAs, K_e = 20 ECORR epochs.  It
goes through pint_tpu and, carried across as plain arrays
(``case_arrays`` -> ``convert.case_from_arrays``), through the port on
the CPU.  Tolerances:

- prepared ctx: bit-identical for integer and tick-derived arrays,
  1e-15 relative for other floats;
- each component's delay within 1e-13 s, the spindown phase at a
  given delay within 1e-12 turns, the full phase within 2^-35 turns;
- hybrid design columns within 1e-10 of each column's max-norm.  Wider
  than the JAX-internal 1e-12 hybrid==jacfwd pin because the two
  frameworks' libm sin/cos/atan2 differ at the ulp level, and the DD
  binary's derivative chain amplifies those ulps;
- the 3-iteration fit under chip_smoke.py's criteria
  (``pint_tpu_torch.tolerances``): prefit residuals within 1e-11 s;
  fitted values, chi^2 per iteration and uncertainties within the
  nominal pins or the normal matrix's conditioning bound 2 eps kappa,
  whichever is larger.
"""

import copy
import json

import numpy as np
import pytest
import torch

from pint_tpu_torch import tolerances as tol
from pint_tpu_torch.convert import case_from_arrays, case_to_arrays
from pint_tpu_torch.fitter import GLSFitter as TFitter
from pint_tpu_torch.residuals import Residuals as TResiduals
from tools.export_torch_case import (b1855_model, case_arrays, epoch_toas,
                                     reference_answers)


@pytest.fixture(scope="module")
def case():
    model = b1855_model()
    toas = epoch_toas(model, 10, 20, seed=0)
    arrays = case_arrays(model, toas)
    arrays.update(reference_answers(model, toas, maxiter=3))
    return model, toas, arrays


@pytest.fixture(scope="module")
def prepared(case):
    model, toas, arrays = case
    jprep = model.prepare(toas)
    tm, tt, tz = case_from_arrays(arrays)
    tprep = tm.prepare(tt, tz, device="cpu")
    return jprep, tprep


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


def test_case_shape_and_roundtrip(case):
    _, toas, arrays = case
    assert len(toas) == 400
    assert int(arrays["ref_ecorr_epochs"]) == 20
    tm, tt, tz = case_from_arrays(arrays)
    back = case_to_arrays(tm, tt, tz)
    for k, v in back.items():
        a, b = np.asarray(v), np.asarray(arrays[k])
        if k == "spec_json":
            # the exporter also records the reference classes' unused
            # options (e.g. fb_terms None); the port's spec is the rest
            mine, ref = json.loads(str(a)), json.loads(str(b))
            assert [c["class"] for c in mine] == [c["class"] for c in ref]
            for c, rc in zip(mine, ref):
                assert c["args"].items() <= rc["args"].items(), c
            continue
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), k


_EXACT = {("Spindown", "dt_ticks"), ("BinaryDD", "dt0"),
          ("BinaryDD", "epoch_ref"), ("AstrometryEquatorial", "dt_pos"),
          ("ScaleToaError", "efac_masks"), ("ScaleToaError", "equad_masks")}


@pytest.mark.parametrize("which", ["data", "tzr"])
def test_prepared_ctx_matches(prepared, which):
    jprep, tprep = prepared
    jctx = jprep.ctx if which == "data" else jprep.tzr_ctx
    tctx = tprep.ctx if which == "data" else tprep.tzr_ctx
    for (comp, key) in sorted(_EXACT) + [("DispersionDM", "dt_yr"),
                                         ("DispersionDM", "bfreq")]:
        a, b = _np(tctx[comp][key]), np.asarray(jctx[comp][key])
        if (comp, key) in _EXACT:
            np.testing.assert_array_equal(a, b, err_msg=f"{comp}.{key}")
        else:
            np.testing.assert_allclose(a, b, rtol=1e-15, atol=0,
                                       err_msg=f"{comp}.{key}")
    assert tctx["BinaryDD"]["kepler_iters"] == \
        jctx["BinaryDD"]["kepler_iters"] == 4
    if which == "data":
        red_t, red_j = tctx["PLRedNoise"], jctx["PLRedNoise"]
        np.testing.assert_allclose(_np(red_t["basis"]), red_j["basis"],
                                   rtol=1e-15, atol=1e-15)
        np.testing.assert_array_equal(_np(red_t["freqs"]), red_j["freqs"])
        # ECORR: segment ids reproduce the dense quantization basis
        ec_t, ec_j = tctx["EcorrNoise"], jctx["EcorrNoise"]
        assert ec_t["counts"] == ec_j["counts"] == (10, 10)
        seg = _np(ec_t["seg"]).astype(np.int64)
        dense = (seg[:, None] == np.arange(20)[None, :]).astype(float)
        np.testing.assert_array_equal(dense, ec_j["basis"])
        perm, off = _np(ec_t["perm"]), _np(ec_t["offsets"])
        for s in range(20):
            rows = perm[off[s]:off[s + 1]]
            assert np.all(np.diff(rows) > 0)
            assert np.array_equal(rows, np.flatnonzero(seg == s))


def test_quantization_matrix_matches(case):
    from pint_tpu.models.noise import create_quantization_matrix as j_qm
    from pint_tpu_torch.models.noise import create_quantization_matrix

    _, toas, _ = case
    t_s = np.asarray(toas.ticks).astype(np.float64) / 2**32
    got = create_quantization_matrix(t_s)
    assert got.shape == (400, 20)
    np.testing.assert_array_equal(got, j_qm(t_s))


def test_component_delays_and_phase_match(prepared):
    jprep, tprep = prepared
    jv = jprep._values_pytree()
    tv = tprep.values_dict()
    jacc = np.zeros(len(jprep.batch))
    for jc, tc in zip(jprep.model.delay_components,
                      tprep.model.delay_components):
        name = type(jc).__name__
        assert name == type(tc).__name__
        jd = np.asarray(jc.delay(jv, jprep.batch, jprep.ctx[name], jacc))
        td = _np(tc.delay(tv, tprep.batch, tprep.ctx[name],
                          torch.tensor(jacc)))
        assert np.max(np.abs(td - jd)) <= 1e-13, name
        jacc = jacc + jd
    sp_j = jprep.model.component("Spindown")
    sp_t = tprep.model.component("Spindown")
    jn, jf = sp_j.phase(jv, jprep.batch, jprep.ctx["Spindown"], jacc)
    tn, tf = sp_t.phase(tv, tprep.batch, tprep.ctx["Spindown"],
                        torch.tensor(jacc))
    np.testing.assert_array_equal(_np(tn), np.asarray(jn))
    assert np.max(np.abs(_np(tf) - np.asarray(jf))) <= 1e-12
    # the full TZR-referenced phase: the float part carries F0 * delay
    # (~1e5 turns) before the renorm, so it agrees to two ulps of that
    # sum, 2^-35 turns (1.6e-13 s at 186 Hz)
    jn, jf = jprep.phase()
    tn, tf = tprep.phase()
    np.testing.assert_array_equal(_np(tn), np.asarray(jn))
    assert np.max(np.abs(_np(tf) - np.asarray(jf))) <= 2.0**-35


def test_noise_sigma_and_weights_match(prepared):
    jprep, tprep = prepared
    jv = jprep._values_pytree()
    tv = tprep.values_dict()
    np.testing.assert_allclose(_np(tprep.scaled_sigma_fn(tv)),
                               np.asarray(jprep.scaled_sigma_fn(jv)),
                               rtol=1e-15, atol=0)
    np.testing.assert_allclose(_np(tprep.noise_weights_fn(tv)),
                               np.asarray(jprep.noise_weights_fn(jv)),
                               rtol=1e-14, atol=0)
    assert tprep.noise_dimensions() == jprep.noise_dimensions()


def test_partition_and_hybrid_design_match(case):
    from pint_tpu.fitter import GLSFitter as JFitter

    model, toas, arrays = case
    jf = JFitter(toas, copy.deepcopy(model))
    tm, tt, tz = case_from_arrays(arrays)
    tf = TFitter(tt, tm, tz, device="cpu")
    assert tf._partition == jf._partition == (
        ("F1",), ("DM", "PB", "T0", "A1", "ECC", "OM", "M2", "SINI", "F0"))
    assert tf._frozen_names == jf._frozen_names
    jvec = np.array([jf.model.values[k] for k in jf._traced_free])
    import jax
    import jax.numpy as jnp

    r_j, J_j = jax.jit(jf._rj)(jnp.asarray(jvec),
                               jf.prepared._values_pytree(), jf._fit_data)
    r_t, J_t = tf._rj(torch.tensor(jvec), tf.prepared.values_dict(),
                      tf._fit_data)
    assert np.max(np.abs(_np(r_t) - np.asarray(r_j))) <= 1e-13
    J_j = np.asarray(J_j)
    colmax = np.max(np.abs(J_j), axis=0)
    rel = np.max(np.abs(_np(J_t) - J_j), axis=0) / colmax
    assert np.all(rel <= 1e-10), dict(zip(jf._traced_free, rel))


def test_fit_matches_jax(case):
    _, _, arrays = case
    tm, tt, tz = case_from_arrays(arrays)
    pre = TResiduals(tt, copy.deepcopy(tm), tz, device="cpu").time_resids
    assert np.max(np.abs(pre - arrays["ref_prefit_time_resids"])) \
        <= tol.PREFIT_S
    f = TFitter(tt, tm, tz, device="cpu")
    chi2 = f.fit_toas(maxiter=3)
    free = [str(p) for p in arrays["free_params"]]
    errs = tol.fit_errors([tm.values[k] for k in free],
                          [tm.uncertainties[k] for k in free],
                          f.chi2_iters, arrays["ref_fitted_values"],
                          arrays["ref_uncertainties"],
                          arrays["ref_chi2_iters"])
    tols = tol.fit_tolerances(f.fit_health["cond_log10"])
    assert f.fit_health["n_truncated"] == 0
    for k in errs:
        assert errs[k] <= tols[k], (k, errs, tols)
    assert abs(chi2 / float(arrays["ref_final_chi2"]) - 1) \
        <= tols["chi2_rel"]
