"""Par-file parsing and model construction (pint_tpu models/builder.py).

:func:`parse_parfile` tokenizes a par file, :func:`choose_components`
selects components by their trigger parameters in the JAX package's
registry order, and :func:`get_model` instantiates the port's
components, parses every value into internal units, records the exact
epoch ticks and the free parameters in the JAX package's order.
:func:`get_model_and_toas` adds the TOAs of a tim file.

Only the components the port has are built.  A par that selects any
other component (ELL1/BT/DDK/... binaries, JUMP, DMX, FD, waves,
glitches, solar wind, other noise families, planetary Shapiro) raises
``NotImplementedError`` naming ROADMAP queue 1 item 9; nothing is
dropped silently.
"""

from __future__ import annotations

import os
import re
import warnings
from typing import Dict, List

import numpy as np

from pint_tpu_torch import SECS_PER_DAY, SECS_PER_JULIAN_YEAR
from pint_tpu_torch.models.absolute_phase import AbsPhase
from pint_tpu_torch.models.astrometry import AstrometryEquatorial
from pint_tpu_torch.models.binary.dd import BinaryDD
from pint_tpu_torch.models.dispersion import DispersionDM
from pint_tpu_torch.models.noise import EcorrNoise, PLRedNoise, ScaleToaError
from pint_tpu_torch.models.parameter import (Param, mjd_value_to_ticks,
                                             prefix_index)
from pint_tpu_torch.models.solar_system_shapiro import SolarSystemShapiro
from pint_tpu_torch.models.spindown import Spindown
from pint_tpu_torch.models.timing_model import TimingModel

__all__ = ["parse_parfile", "choose_components", "get_model",
           "get_model_and_toas"]

#: the ROADMAP item a component the port lacks waits for
_WAITS = "ROADMAP queue 1 item 9 (remaining timing components)"

#: par keys that are model metadata, not fit parameters
_META_KEYS = {
    "PSR", "PSRJ", "PSRB", "EPHEM", "CLK", "CLOCK", "UNITS", "TIMEEPH",
    "T2CMETHOD", "DILATEFREQ", "NTOA", "TRES",
    "CHI2", "CHI2R", "TZRSITE", "INFO", "BINARY", "START", "FINISH",
    "DMDATA", "MODE", "EPHVER", "NITS",
    "IBOOT", "DMX", "TRACK",
}

#: parameter-name aliases -> canonical
_ALIASES = {
    "E": "ECC",
    "PSRJ": "PSR",
    "PSRB": "PSR",
    "LAMBDA": "ELONG",
    "BETA": "ELAT",
    "PMLAMBDA": "PMELONG",
    "PMBETA": "PMELAT",
    "A1DOT": "XDOT",
    "T2EFAC": "EFAC",
    "TNEF": "EFAC",
    "T2EQUAD": "EQUAD",
    "TNECORR": "ECORR",
    "NE1AU": "NE_SW",
    "SOLARN0": "NE_SW",
}

_FDJUMP_RE = re.compile(r"^FD(\d+)JUMP$")
_FDJUMP_ALT_RE = re.compile(r"^FDJUMP(\d+)$")

#: mask-parameter families: "KEY selector value [fit [unc]]" par lines
_MASK_KEYS = (
    "JUMP", "DMJUMP", "EFAC", "EQUAD", "TNEQ", "ECORR",
    "DMEFAC", "DMEQUAD", "FDJUMPDM",
    "TNBANDAMP", "TNBANDGAM", "TNSYSAMP", "TNSYSGAM",
)

#: every component class of the JAX package with its trigger
#: parameters, in its registry order (the order components are chosen
#: and parameters numbered in)
_REGISTRY = (
    ("AbsPhase", ("TZRMJD",)),
    ("PhaseOffset", ("PHOFF",)),
    ("AstrometryEquatorial", ("RAJ", "DECJ")),
    ("AstrometryEcliptic", ("ELONG", "ELAT")),
    ("DispersionDM", ("DM",)),
    ("DispersionDMX", ("DMX",)),
    ("DispersionJump", ("DMJUMP",)),
    ("PhaseJump", ("JUMP",)),
    ("ScaleToaError", ("EFAC", "EQUAD", "TNEQ")),
    ("ScaleDmError", ("DMEFAC", "DMEQUAD")),
    ("EcorrNoise", ("ECORR",)),
    ("PLBandNoise", ("TNBANDAMP",)),
    ("PLSystemNoise", ("TNSYSAMP",)),
    ("PLRedNoise", ("TNREDAMP", "RNAMP")),
    ("PLDMNoise", ("TNDMAMP",)),
    ("PLChromNoise", ("TNCHROMAMP",)),
    ("SolarSystemShapiro", ("PLANET_SHAPIRO",)),
    ("Spindown", ("F0",)),
    ("WaveX", ("WXFREQ",)),
    ("DMWaveX", ("DMWXFREQ",)),
    ("CMWaveX", ("CMWXFREQ",)),
    ("Wave", ("WAVE_OM",)),
    ("IFunc", ("SIFUNC",)),
    ("Glitch", ("GLEP",)),
    ("PiecewiseSpindown", ("PWEP",)),
    ("ChromaticCM", ("CM",)),
    ("ChromaticCMX", ("CMX",)),
    ("FD", ("FD1",)),
    ("FDJumpDM", ("FDJUMPDM",)),
    ("SolarWindDispersion", ("NE_SW", "NE1AU", "SOLARN0")),
    ("SolarWindDispersionX", ("SWXDM",)),
    ("TroposphereDelay", ("CORRECT_TROPOSPHERE",)),
)

_DEG_PER_YEAR = np.pi / 180.0 / SECS_PER_JULIAN_YEAR


# --- the ported components: instance, parameter metadata, defaults --------


def _derivs(pardict, stem, skip=()):
    n = 0
    for key in pardict:
        pi = prefix_index(key)
        if pi and pi[0] == stem and not key.startswith(skip):
            n = max(n, pi[1])
    return n


def _masks(pardict, key):
    return [s for s, _ in pardict.get("__MASKS__", {}).get(key, [])]


def _astrometry(pardict):
    comp = AstrometryEquatorial()
    meta = [Param("RAJ", kind="angle", hourangle=True),
            Param("DECJ", kind="angle"),
            Param("PMRA", units="mas/yr"), Param("PMDEC", units="mas/yr"),
            Param("PX", units="mas"),
            Param("POSEPOCH", kind="mjd", fittable=False)]
    return comp, meta, {"PMRA": 0.0, "PMDEC": 0.0, "PX": 0.0,
                        "POSEPOCH": np.nan}


def _shapiro(pardict):
    return (SolarSystemShapiro(),
            [Param("PLANET_SHAPIRO", kind="bool", fittable=False)],
            {"PLANET_SHAPIRO": 0.0})


def _dispersion(pardict):
    n = _derivs(pardict, "DM", skip=("DMX",))
    meta = [Param("DM", units="pc cm^-3")] + [
        Param(f"DM{k}", units=f"pc cm^-3/yr^{k}") for k in range(1, n + 1)
    ] + [Param("DMEPOCH", kind="mjd", fittable=False)]
    d = {f"DM{k}": 0.0 for k in range(1, n + 1)}
    d.update(DM=0.0, DMEPOCH=np.nan)
    return DispersionDM(num_dm_derivs=n), meta, d


def _abs_phase(pardict):
    return (AbsPhase(),
            [Param("TZRMJD", kind="mjd", fittable=False),
             Param("TZRFRQ", units="MHz", fittable=False)],
            {"TZRMJD": np.nan, "TZRFRQ": np.inf})


def _spindown(pardict):
    n = max(_derivs(pardict, "F"), 1)
    meta = [Param("F0", units="Hz")] + [
        Param(f"F{k}", units=f"Hz/s^{k}") for k in range(1, n + 1)
    ] + [Param("PEPOCH", kind="mjd", fittable=False)]
    d = {f"F{k}": 0.0 for k in range(1, n + 1)}
    d["PEPOCH"] = 0.0
    return Spindown(num_freq_derivs=n), meta, d


def _scale_toa_error(pardict):
    comp = ScaleToaError(efac_selects=_masks(pardict, "EFAC"),
                         equad_selects=_masks(pardict, "EQUAD"),
                         tneq_selects=_masks(pardict, "TNEQ"))
    meta, d = [], {}
    for i, sel in enumerate(comp.efac_selects, start=1):
        meta.append(Param(f"EFAC{i}", select=sel))
        d[f"EFAC{i}"] = 1.0
    for i, sel in enumerate(comp.equad_selects, start=1):
        meta.append(Param(f"EQUAD{i}", units="us", scale=1e-6, select=sel))
        d[f"EQUAD{i}"] = 0.0
    for i, sel in enumerate(comp.tneq_selects, start=1):
        meta.append(Param(f"TNEQ{i}", units="log10(s)", select=sel))
        d[f"TNEQ{i}"] = -np.inf
    return comp, meta, d


def _ecorr(pardict):
    comp = EcorrNoise(selects=_masks(pardict, "ECORR"))
    meta = [Param(f"ECORR{i}", units="us", scale=1e-6, select=sel)
            for i, sel in enumerate(comp.selects, start=1)]
    return comp, meta, {p.name: 0.0 for p in meta}


def _red_noise(pardict):
    comp = PLRedNoise(use_rn="TNREDAMP" not in pardict
                      and "RNAMP" in pardict)
    meta = [Param("TNREDAMP"), Param("TNREDGAM"),
            Param("TNREDC", fittable=False), Param("RNAMP"),
            Param("RNIDX")]
    return comp, meta, {p.name: np.nan for p in meta}


def _binary_dd(pardict):
    if any((pi := prefix_index(k)) and pi[0] == "FB" for k in pardict):
        raise NotImplementedError(
            "BINARY DD with the FBn orbit parameterization is not ported "
            f"yet ({_WAITS})")
    meta = [
        Param("PB", units="s", scale=SECS_PER_DAY),
        Param("PBDOT", unit_scale=True),
        Param("XPBDOT", unit_scale=True),
        Param("T0", kind="mjd"),
        Param("A1", units="ls"),
        Param("XDOT", unit_scale=True, aliases=("A1DOT",)),
        Param("ECC", aliases=("E",)),
        Param("EDOT", unit_scale=True, units="1/s"),
        Param("OM", units="rad", scale=np.pi / 180.0),
        Param("OMDOT", units="rad/s", scale=_DEG_PER_YEAR),
        Param("GAMMA", units="s"),
        Param("M2", units="Msun"),
        Param("SINI"),
        Param("DR"),
        Param("DTH", aliases=("DTHETA",)),
        Param("A0", units="s"),
        Param("B0", units="s"),
    ]
    d = {"T0": 0.0, "PB": np.nan, "PBDOT": 0.0, "XPBDOT": 0.0}
    d.update(A1=0.0, XDOT=0.0, ECC=0.0, EDOT=0.0, OM=0.0, OMDOT=0.0,
             GAMMA=0.0, M2=0.0, SINI=0.0, DR=0.0, DTH=0.0, A0=0.0, B0=0.0)
    return BinaryDD(), meta, d


#: JAX class name -> builder of (port instance, [Param], defaults)
_PORTED = {
    "AbsPhase": _abs_phase,
    "AstrometryEquatorial": _astrometry,
    "DispersionDM": _dispersion,
    "ScaleToaError": _scale_toa_error,
    "EcorrNoise": _ecorr,
    "PLRedNoise": _red_noise,
    "SolarSystemShapiro": _shapiro,
    "Spindown": _spindown,
}


# --- parsing -----------------------------------------------------------------


def parse_parfile(path_or_text: str) -> Dict[str, List[List[str]]]:
    """Tokenize a par file: {KEY: [tokens-after-key, ...]} (repeats kept,
    e.g. multiple EFAC lines)."""
    if "\n" in path_or_text:
        text = path_or_text
    elif os.path.exists(path_or_text):
        with open(path_or_text) as f:
            text = f.read()
    else:
        # a single line without newline is a path, not par text
        raise FileNotFoundError(f"par file not found: {path_or_text!r}")
    out: Dict[str, List[List[str]]] = {}
    for raw in text.splitlines():
        line = raw.split("#")[0].rstrip()
        if not line.strip() or line.startswith(("C ", "c ")):
            continue
        tokens = line.split()
        out.setdefault(tokens[0].upper(), []).append(tokens[1:])
    return out


def parse_mask_select(tokens) -> tuple:
    """Mask tokens -> (select, remaining tokens): ``-fe L-wide 0.001 1``
    -> ("flag", "fe", "L-wide"); ``MJD 50000 51000 ...`` -> ("mjd",
    50000.0, 51000.0)."""
    if not tokens:
        return ("all",), []
    t0 = tokens[0]
    if t0.startswith("-"):
        return ("flag", t0.lstrip("-"), tokens[1]), tokens[2:]
    u = t0.upper()
    if u == "MJD":
        return ("mjd", float(tokens[1]), float(tokens[2])), tokens[3:]
    if u == "FREQ":
        return ("freq", float(tokens[1]), float(tokens[2])), tokens[3:]
    if u in ("TEL", "T"):
        return ("tel", tokens[1]), tokens[2:]
    return ("all",), tokens


def choose_components(pardict) -> List[str]:
    """Names of the component classes whose trigger parameters appear,
    in the JAX package's registry order, SolarSystemShapiro always
    included and the binary family last."""
    keys = set(pardict)
    chosen = []
    for name, trig in _REGISTRY:
        for t in trig:
            if t in keys or any(
                    k.startswith(t + "_")
                    or (k.startswith(t) and k[len(t):].isdigit())
                    for k in keys):
                chosen.append(name)
                break
    if "SolarSystemShapiro" not in chosen:
        chosen.append("SolarSystemShapiro")
    if any(_FDJUMP_RE.match(k) for k in pardict.get("__MASKS__", {})):
        chosen.append("FDJump")
    if "BINARY" in pardict:
        chosen.append("Binary" + pardict["BINARY"][0][0].upper())
    return chosen


def get_model(parfile) -> TimingModel:
    """Build a TimingModel from a par file (path or text)."""
    pardict: Dict[str, List[List[str]]] = {}
    for k, v in parse_parfile(parfile).items():
        m = _FDJUMP_ALT_RE.match(k)
        if m:  # tempo2 "FDJUMPp" spelling -> internal "FDpJUMP"
            k = f"FD{m.group(1)}JUMP"
        pardict.setdefault(_ALIASES.get(k, k), []).extend(v)

    units = (pardict.get("UNITS", [["TDB"]])[0] or ["TDB"])[0].upper()
    if units not in ("TDB", ""):
        raise NotImplementedError(
            f"UNITS {units}: the TCB conversion is not ported yet "
            f"({_WAITS})")
    if "BINARY" in pardict and pardict["BINARY"][0][0].upper() != "DD":
        raise NotImplementedError(
            f"BINARY {pardict['BINARY'][0][0]}: the port has DD only "
            f"({_WAITS})")

    mask_keys = list(_MASK_KEYS) + [k for k in pardict
                                    if _FDJUMP_RE.match(k)]
    masks: Dict[str, list] = {}
    for key in mask_keys:
        for tokens in pardict.get(key, []):
            masks.setdefault(key, []).append(parse_mask_select(tokens))
    if masks:
        pardict["__MASKS__"] = masks  # type: ignore

    comps, meta, defaults = [], [], {}
    for name in choose_components(pardict):
        if name == "BinaryDD":
            build = _binary_dd
        else:
            build = _PORTED.get(name)
        if build is None:
            raise NotImplementedError(
                f"the par selects {name}, which is not ported yet "
                f"({_WAITS})")
        comp, pm, d = build(pardict)
        comps.append(comp)
        meta.extend((comp, p) for p in pm)
        for k, v in d.items():
            defaults.setdefault(k, v)

    model = TimingModel(components=comps, name=str(parfile)[:120])
    # parameters in the JAX package's order: components sorted by
    # category (stable), each component's parameters in its own order
    order = {id(c): i for i, c in enumerate(model.components)}
    meta.sort(key=lambda cp: order[id(cp[0])])
    params: Dict[str, Param] = {p.name: p for _, p in meta}
    for p in params.values():
        model.values[p.name] = defaults.get(p.name, np.nan)

    alias_map = {}
    for p in params.values():
        for a in p.aliases:
            alias_map.setdefault(a, p.name)
    consumed = set()
    for key, occurrences in pardict.items():
        if key.startswith("__") or key in mask_keys:
            consumed.add(key)
            continue
        if key in _META_KEYS:
            model.meta[key] = " ".join(occurrences[0])
            consumed.add(key)
            continue
        pname = key if key in params else alias_map.get(key)
        p = params.get(pname) if pname else None
        if p is None:
            continue
        tokens = occurrences[0]
        if not tokens:
            continue
        p.raw = tokens[0]
        model.values[pname] = p.parse(tokens[0])
        if p.kind == "mjd":
            model.epoch_ticks[pname] = mjd_value_to_ticks(tokens[0])
        if len(tokens) > 1 and p.fittable:
            if tokens[1] in ("1", "2"):
                p.frozen = False
            if len(tokens) > 2:
                try:
                    p.uncertainty = p.parse_uncertainty(tokens[2])
                except ValueError:
                    pass
        consumed.add(key)

    # mask-parameter values: KEYn in file order (EFAC1, EFAC2, ...)
    for key, entries in masks.items():
        for i, (_sel, rest) in enumerate(entries, start=1):
            name = f"{key}{i}"
            if name in params and rest:
                model.values[name] = params[name].parse(rest[0])
                if len(rest) > 1 and rest[1] in ("1", "2"):
                    params[name].frozen = False
                if len(rest) > 2:
                    try:
                        params[name].uncertainty = (
                            params[name].parse_uncertainty(rest[2]))
                    except ValueError:
                        pass

    unknown = [k for k in pardict
               if k not in consumed and not k.startswith("__")]
    noisy = [k for k in unknown
             if not k.startswith(("DMXEP_", "DMXF1_", "DMXF2_"))]
    if noisy:
        warnings.warn(
            f"par parameters not (yet) supported, carried as metadata: "
            f"{sorted(noisy)}")
    for k in unknown:
        model.meta.setdefault("__unknown__", {})[k] = pardict[k]

    if planets_requested(model):
        raise NotImplementedError(
            f"PLANET_SHAPIRO: planetary Shapiro delays are not ported yet "
            "(ROADMAP queue 1 item 4)")
    if np.isnan(model.values.get("F0", np.nan)):
        raise ValueError("par file lacks F0 (no spindown model)")
    have_ra = not np.isnan(model.values.get("RAJ", np.nan))
    have_dec = not np.isnan(model.values.get("DECJ", np.nan))
    if have_ra != have_dec:
        raise ValueError("par file sets one of RAJ/DECJ but not the "
                         "other: incomplete sky position")
    model.params = params
    model.free_params = [n for n, p in params.items() if not p.frozen]
    model.uncertainties = {n: p.uncertainty for n, p in params.items()
                           if p.uncertainty is not None}
    return model


def planets_requested(model) -> bool:
    """Whether the par requests planet Shapiro delays (pint_tpu
    builder.py:386)."""
    return bool(
        model.meta.get("PLANET_SHAPIRO", "N").upper() in ("Y", "1", "TRUE")
    ) or bool(model.values.get("PLANET_SHAPIRO", 0.0))


def get_model_and_toas(parfile, timfile, **kw):
    """(model, TOAs) from a par file and a tim file (pint_tpu
    builder.py:401).  The TOAs are host-side; the fitters and
    ``Residuals`` take them with the model and build the TZR TOA
    from it."""
    from pint_tpu_torch.toa import get_TOAs

    model = get_model(parfile)
    ephem = model.meta.get("EPHEM", "builtin")
    clk = (model.meta.get("CLK") or model.meta.get("CLOCK") or "").upper()
    if "BIPM" in clk and "include_bipm" not in kw:
        kw["include_bipm"] = True
        kw.setdefault("bipm_version",
                      clk.replace("TT(", "").replace(")", ""))
    toas = get_TOAs(timfile, ephem=ephem, planets=False, **kw)
    if any("tim_jump" in f or "gui_jump" in f for f in toas.flags):
        raise NotImplementedError(
            "tim-file JUMP commands need PhaseJump, which is not ported "
            f"yet ({_WAITS})")
    return model, toas
