"""The state carried across from pint_tpu: a timing case as plain
arrays.

A case holds the TOA table, the one-row TZR table, every model value as
float64, the exact ``epoch_ticks`` as int64, the component spec (class
names and constructor arguments, as JSON) and the free parameters in fit
order.  ``tools/export_torch_case.py`` writes it from a pint_tpu
``(model, toas)`` pair, with the JAX answers beside it as ``ref_*``
arrays; :func:`case_from_arrays` turns it into this package's objects
and :func:`case_to_arrays` back.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from pint_tpu_torch.models.absolute_phase import AbsPhase
from pint_tpu_torch.models.astrometry import AstrometryEquatorial
from pint_tpu_torch.models.binary.dd import BinaryDD
from pint_tpu_torch.models.dispersion import DispersionDM
from pint_tpu_torch.models.noise import EcorrNoise, PLRedNoise, ScaleToaError
from pint_tpu_torch.models.solar_system_shapiro import SolarSystemShapiro
from pint_tpu_torch.models.spindown import Spindown
from pint_tpu_torch.models.timing_model import TimingModel
from pint_tpu_torch.toa import TOATable

#: the 10k-TOA, 400-epoch B1855-like case the chip check fits
B1855_EPOCHS_10K = Path(__file__).resolve().parent / "data" \
    / "b1855_epochs_10k.npz"
#: the 68-pulsar, 500-TOA synthetic array of the GW path, with the JAX
#: CPU answers (``tools/export_torch_pta_case.py``)
PTA68_500 = Path(__file__).resolve().parent / "data" / "pta68_500.npz"
#: the heterogeneous 68-pulsar, 500-TOA batch of bench_pta (isolated and
#: DD members alternating), with the JAX CPU answers of ``PTABatch``
#: (``tools/export_torch_pta_batch_case.py``)
PTA68_500_BATCH = Path(__file__).resolve().parent / "data" \
    / "pta68_500_batch.npz"
#: the JAX CPU answers of the GWB posterior on that array
#: (``tools/export_torch_hmc_case.py``)
HMC_CASE = Path(__file__).resolve().parent / "data" / "pta68_500_hmc.npz"
#: the par and tim of the B1855-like 10k epoch case, and the JAX CPU
#: answers of ``get_model_and_toas`` and both fits on them
#: (``tools/export_torch_tim_case.py``)
B1855_PAR = Path(__file__).resolve().parent / "data" / "b1855_like.par"
B1855_TIM = Path(__file__).resolve().parent / "data" / "b1855_epochs_10k.tim"
B1855_TIM_ANSWERS = Path(__file__).resolve().parent / "data" \
    / "b1855_epochs_10k_answers.npz"
#: the par without its ECORR and TNRed lines (a WLS model of the same
#: TOAs), and the JAX CPU answers of the chi^2 grids and downhill fits
#: on the par/tim case (``tools/export_torch_grid_case.py``)
B1855_WHITE_PAR = Path(__file__).resolve().parent / "data" \
    / "b1855_white.par"
B1855_GRID_ANSWERS = Path(__file__).resolve().parent / "data" \
    / "b1855_grid_answers.npz"
#: the JAX CPU answers of the timing posterior's ensemble chains on the
#: par/tim case (``tools/export_torch_mcmc_case.py``)
B1855_MCMC_ANSWERS = Path(__file__).resolve().parent / "data" \
    / "b1855_mcmc_answers.npz"
#: the 11 nights appended by the streaming check, and the JAX CPU
#: answers of the streamed GLS and WLS fits on the par/tim case
#: (``tools/export_torch_stream_case.py``)
B1855_STREAM_NIGHTS = Path(__file__).resolve().parent / "data" \
    / "b1855_stream_nights.tim"
B1855_STREAM_ANSWERS = Path(__file__).resolve().parent / "data" \
    / "b1855_stream_answers.npz"
#: the JAX CPU answers of the pulse-number (TRACK -2) and PHASE-command
#: fits, with their par and tim text (``tools/export_torch_pn_case.py``)
PN_ANSWERS = Path(__file__).resolve().parent / "data" / "pn_answers.npz"
#: a 4-pulsar array with 100 red-noise modes (capacities ~203 wide),
#: with the JAX CPU answers of its likelihood and posterior
PTA4_WIDE = Path(__file__).resolve().parent / "data" / "pta4_wide.npz"
#: the JAX CPU answers of the dense (kron=False) likelihood on the
#: pta68_500 array (``tools/export_torch_crn_dense_case.py``)
CRN_DENSE_ANSWERS = Path(__file__).resolve().parent / "data" \
    / "crn_dense_answers.npz"
#: the photon case (a 300 Hz DD pulsar from 10^5 barycentred, weighted
#: Fermi-like photons) with the JAX CPU answers of its ingest, photon
#: MCMC chains and template fit (``tools/export_torch_photon_case.py``)
PHOTON_FERMI_1E5 = Path(__file__).resolve().parent / "data" \
    / "photon_fermi_1e5.npz"
#: the JAX CPU answers of the dense GWB posterior on the pta68_500 array
#: at two theta of the HMC case (``tools/export_torch_hmc_dense_case.py``)
HMC_DENSE_ANSWERS = Path(__file__).resolve().parent / "data" \
    / "pta68_500_hmc_dense.npz"

#: component class -> constructor arguments the spec may carry
_COMPONENTS = {
    "AstrometryEquatorial": (AstrometryEquatorial, ()),
    "SolarSystemShapiro": (SolarSystemShapiro, ()),
    "DispersionDM": (DispersionDM, ("num_dm_derivs",)),
    "BinaryDD": (BinaryDD, ()),
    "AbsPhase": (AbsPhase, ()),
    "Spindown": (Spindown, ("num_freq_derivs",)),
    "ScaleToaError": (ScaleToaError,
                      ("efac_selects", "equad_selects", "tneq_selects")),
    "EcorrNoise": (EcorrNoise, ("selects",)),
    "PLRedNoise": (PLRedNoise, ("use_rn",)),
}


def _table_from(arrays, prefix) -> TOATable:
    flags = {}
    for key in arrays.get(f"{prefix}flag_keys", np.zeros(0, np.str_)):
        key = str(key)
        flags[key] = (np.asarray(arrays[f"{prefix}flag_{key}_names"]),
                      np.asarray(arrays[f"{prefix}flag_{key}_index"],
                                 dtype=np.int32))
    return TOATable(
        ticks=np.asarray(arrays[f"{prefix}ticks"], dtype=np.int64),
        freq_mhz=np.asarray(arrays[f"{prefix}freq_mhz"], dtype=np.float64),
        error_us=np.asarray(arrays[f"{prefix}error_us"], dtype=np.float64),
        mjd_float=np.asarray(arrays[f"{prefix}mjd_float"], np.float64),
        ssb_obs_pos=np.asarray(arrays[f"{prefix}ssb_obs_pos"], np.float64),
        ssb_obs_vel=np.asarray(arrays[f"{prefix}ssb_obs_vel"], np.float64),
        obs_sun_pos=np.asarray(arrays[f"{prefix}obs_sun_pos"], np.float64),
        flags=flags)


def _component(entry):
    cls, allowed = _COMPONENTS[entry["class"]]
    args = {}
    for k, v in entry.get("args", {}).items():
        if k not in allowed:
            if v in (None, False, [], ()):
                continue  # an unused option of the reference class
            raise NotImplementedError(
                f"{entry['class']}: option {k}={v!r} is not ported")
        args[k] = ([tuple(s) for s in v] if k.endswith("selects")
                   else v)
    return cls(**args)


def case_from_arrays(arrays):
    """(TimingModel, TOATable, TZR TOATable or None) from a case's
    arrays (a dict or an ``np.load`` result)."""
    spec = json.loads(str(np.asarray(arrays["spec_json"])))
    comps = [_component(e) for e in spec]
    names = [str(k) for k in arrays["value_names"]]
    vals = np.asarray(arrays["value_vals"], dtype=np.float64)
    values = {k: float(v) for k, v in zip(names, vals)}
    epoch_ticks = {str(k): int(v) for k, v in zip(
        arrays["epoch_names"], np.asarray(arrays["epoch_ticks"], np.int64))}
    model = TimingModel(
        components=comps, values=values, epoch_ticks=epoch_ticks,
        free_params=[str(p) for p in arrays["free_params"]],
        name=str(np.asarray(arrays.get("psr", ""))))
    toas = _table_from(arrays, "toa_")
    tzr = (_table_from(arrays, "tzr_")
           if "tzr_ticks" in arrays else None)
    return model, toas, tzr


def _table_arrays(prefix, t: TOATable):
    out = {
        f"{prefix}ticks": t.ticks, f"{prefix}freq_mhz": t.freq_mhz,
        f"{prefix}error_us": t.error_us, f"{prefix}mjd_float": t.mjd_float,
        f"{prefix}ssb_obs_pos": t.ssb_obs_pos,
        f"{prefix}ssb_obs_vel": t.ssb_obs_vel,
        f"{prefix}obs_sun_pos": t.obs_sun_pos,
        f"{prefix}flag_keys": np.asarray(sorted(t.flags), dtype=np.str_),
    }
    for k, (names, index) in t.flags.items():
        out[f"{prefix}flag_{k}_names"] = np.asarray(names, dtype=np.str_)
        out[f"{prefix}flag_{k}_index"] = np.asarray(index, dtype=np.int32)
    return out


def _spec(model):
    spec = []
    for c in model.components:
        name = type(c).__name__
        args = {}
        for a in _COMPONENTS[name][1]:
            v = getattr(c, a)
            args[a] = [list(s) for s in v] if a.endswith("selects") else v
        spec.append({"class": name, "args": args})
    return spec


def case_to_arrays(model, toas, tzr=None) -> dict:
    """The inverse of :func:`case_from_arrays`."""
    out = _table_arrays("toa_", toas)
    if tzr is not None:
        out.update(_table_arrays("tzr_", tzr))
    names = list(model.values)
    out["value_names"] = np.asarray(names, dtype=np.str_)
    out["value_vals"] = np.asarray([model.values[k] for k in names],
                                   dtype=np.float64)
    out["epoch_names"] = np.asarray(list(model.epoch_ticks), dtype=np.str_)
    out["epoch_ticks"] = np.asarray(list(model.epoch_ticks.values()),
                                    dtype=np.int64)
    out["spec_json"] = np.asarray(json.dumps(_spec(model)))
    out["free_params"] = np.asarray(model.free_params, dtype=np.str_)
    out["psr"] = np.asarray(model.name)
    return out


def _primitive_state(prim) -> dict:
    """A template primitive's constructor arguments (and, for the
    empirical primitives, their measured state) as JSON-ready values."""
    name = type(prim).__name__
    if name == "LCEmpiricalFourier":
        return {"nharm": int(prim.nharm),
                "alphas": [float(a) for a in prim.alphas],
                "betas": [float(b) for b in prim.betas]}
    if name == "LCKernelDensity":
        return {"resolution": float(prim.resolution), "bw": prim.bw,
                "vals": [float(v) for v in prim.vals]}
    return {f: (int(v) if isinstance(v, (int, np.integer)) else float(v))
            for f, v in vars(prim).items()}


def template_to_arrays(template, prefix="template") -> dict:
    """A light-curve template of either package as plain arrays:
    ``<prefix>_spec`` (JSON: each primitive's class name and constructor
    arguments, or ``"binned"``) and ``<prefix>_params`` (float64: the
    template's parameter vector, or the bin heights of a binned
    profile)."""
    if isinstance(template, (list, np.ndarray)):
        return {f"{prefix}_spec": np.asarray(json.dumps("binned")),
                f"{prefix}_params": np.asarray(template, np.float64)}
    spec = [{"class": type(p).__name__, "args": _primitive_state(p)}
            for p in template.primitives]
    return {f"{prefix}_spec": np.asarray(json.dumps(spec)),
            f"{prefix}_params": np.asarray(template.params, np.float64)}


def template_from_arrays(arrays, prefix="template"):
    """The inverse of :func:`template_to_arrays`: this package's
    :class:`~pint_tpu_torch.templates.LCTemplate` with the stored
    parameters, or the bin heights (numpy) of a binned profile."""
    from pint_tpu_torch import templates as tpl

    spec = json.loads(str(np.asarray(arrays[f"{prefix}_spec"])))
    params = np.asarray(arrays[f"{prefix}_params"], np.float64)
    if spec == "binned":
        return params.copy()
    prims = []
    for e in spec:
        args = dict(e["args"])
        if e["class"] == "LCEmpiricalFourier":
            p = tpl.LCEmpiricalFourier(nharm=args["nharm"])
            p.alphas = np.asarray(args["alphas"])
            p.betas = np.asarray(args["betas"])
        elif e["class"] == "LCKernelDensity":
            p = tpl.LCKernelDensity(bw=args["bw"],
                                    resolution=args["resolution"])
            p.vals = np.asarray(args["vals"])
        else:
            p = getattr(tpl, e["class"])(**args)
        prims.append(p)
    t = tpl.LCTemplate(prims)
    t.params = params.copy()
    return t


def load_arrays(path) -> dict:
    """Every array of an ``.npz`` file, loaded without pickles."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def load_case(path=B1855_EPOCHS_10K):
    """(arrays dict, model, toas, tzr) from a case file."""
    arrays = load_arrays(path)
    model, toas, tzr = case_from_arrays(arrays)
    return arrays, model, toas, tzr


def pta_case_from_arrays(arrays):
    """``[(model, toas, tzr), ...]`` of a PTA case: pulsar i's case
    arrays carry the prefix ``p{i:02d}_``."""
    out = []
    for i in range(int(arrays["n_psr"])):
        pre = f"p{i:02d}_"
        out.append(case_from_arrays(
            {k[len(pre):]: v for k, v in arrays.items()
             if k.startswith(pre)}))
    return out


def load_pta_case(path=PTA68_500):
    """(arrays dict, [(model, toas, tzr), ...]) from a PTA case file."""
    arrays = load_arrays(path)
    return arrays, pta_case_from_arrays(arrays)


def load_hmc_reference(path=HMC_CASE) -> dict:
    """The arrays of a GWB-posterior reference file: layout, lnprob and
    its gradient at stored theta, and an injected-draw run with its
    result (``tools/export_torch_hmc_case.py``)."""
    return load_arrays(path)
