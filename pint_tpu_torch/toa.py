"""TOA ingest (pint_tpu toa.py): tim parsing, the host TOA container,
and the tables the device path reads.

- :func:`read_tim` parses a ``.tim`` file (tempo2 / Princeton / Parkes /
  ITOA lines and the MODE/FORMAT/TIME/EFAC/EQUAD/PHASE/JUMP/SKIP/INCLUDE/
  END commands) with the pure-Python line parser; the JAX package's
  optional ctypes parser over ``native/`` is not ported.
- :class:`TOAs` applies the observatory clock chains, converts to exact
  int64 TDB ticks and evaluates the observatory and solar-system
  geometry per TOA, all on the host in numpy and exact integers.
- :class:`TOATable` is the columnar host table the models prepare from
  (flags as an index into a names array per key), and :class:`TOABatch`
  its device struct-of-arrays (pint_tpu toa.py:635-651).
  ``TOAs.to_table()`` / ``TOAs.to_batch(device)`` emit them.

:func:`get_TOAs` reads and prepares a tim file; the on-disk cache
(``save_cache``/``load_cache``) is not ported.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pint_tpu_torch.obs import get_observatory
from pint_tpu_torch.time.mjd import (
    mjd_string_to_day_frac,
    mjd_to_ticks_tdb,
    mjd_to_ticks_utc,
)

__all__ = ["TOA", "TOAs", "TOATable", "TOABatch", "get_TOAs", "read_tim"]


@dataclass
class TOA:
    """One parsed TOA (host side only; never reaches the device)."""

    mjd_day: int
    frac_num: int
    frac_den: int
    error_us: float
    freq_mhz: float
    obs: str
    flags: dict = field(default_factory=dict)
    name: str = ""


# --- tim file parsing -------------------------------------------------------


def _toa_line_format(line: str, tempo2_mode: bool = False) -> str:
    """Classify a TOA data line (reference behavior: toa.py:441).

    Stateful like the reference: after a ``FORMAT 1`` command every data
    line is Tempo2; otherwise Princeton is the legacy default, with
    Parkes/ITOA recognized by their fixed-column signatures.
    """
    if not line.strip():
        return "Blank"
    if line.startswith(("C ", "c ", "#", "CC ")):
        return "Comment"
    first = line.split()[0] if line.split() else ""
    if first.upper() in _COMMANDS:
        return "Command"
    if tempo2_mode or len(line) > 80:
        return "Tempo2"
    if line.startswith(" ") and len(line) > 41 and line[41] == ".":
        return "Parkes"
    if (
        len(line) > 25
        and line[0].isalpha()
        and line[1].isalpha()
        and line[14:15] == "."
    ):
        return "ITOA"
    return "Princeton"


_COMMANDS = {
    "FORMAT",
    "MODE",
    "TIME",
    "EFAC",
    "EQUAD",
    "EMAX",
    "EMIN",
    "FMAX",
    "FMIN",
    "SKIP",
    "NOSKIP",
    "END",
    "PHASE",
    "PHA1",
    "PHA2",
    "JUMP",
    "INCLUDE",
    "INFO",
    "TRACK",
}


def _parse_line(line: str, fmt: str):
    """One data line -> TOA (without command-state effects applied)."""
    if fmt == "Tempo2":
        parts = line.split()
        if len(parts) < 5:
            raise ValueError(f"bad tempo2 TOA line: {line!r}")
        name, freq, mjd, err, obs = parts[:5]
        flags = {}
        i = 5
        while i < len(parts):
            tok = parts[i]
            if tok.startswith("-") and not _is_number(tok):
                key = tok.lstrip("-")
                if i + 1 < len(parts):
                    flags[key] = parts[i + 1]
                    i += 2
                else:
                    flags[key] = ""
                    i += 1
            else:
                i += 1
        d, n, den = mjd_string_to_day_frac(mjd)
        return TOA(d, n, den, float(err), float(freq), obs, flags, name)
    if fmt == "Princeton":
        obs = line[0]
        name = line[2:15].strip()
        freq = float(line[15:24])
        d, n, den = mjd_string_to_day_frac(line[24:44])
        err = float(line[44:53])
        flags = {}
        dmc = line[68:78].strip()
        if dmc:
            flags["ddm"] = dmc
        return TOA(d, n, den, err, freq, obs, flags, name)
    if fmt == "Parkes":
        name = line[1:25].strip()
        freq = float(line[25:34])
        d, n, den = mjd_string_to_day_frac(line[34:55])
        # phase offset at line[55:63] (rarely used)
        err = float(line[63:71])
        obs = line[79] if len(line) > 79 else line.strip()[-1]
        return TOA(d, n, den, err, freq, obs, {}, name)
    if fmt == "ITOA":
        name = line[0:2]
        d, n, den = mjd_string_to_day_frac(line[9:28])
        err = float(line[28:34])
        freq = float(line[34:45])
        obs = line[57:59].strip()
        return TOA(d, n, den, err, freq, obs, {}, name)
    raise ValueError(f"unhandled TOA format {fmt}")


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def read_tim(path, _depth=0):
    """Parse a .tim file -> list[TOA], applying command state
    (TIME/EFAC/EQUAD/PHASE/JUMP/SKIP/INCLUDE; reference toa.py:701)."""
    toas = []
    state = {
        "time_offset_s": 0.0,
        "efac": 1.0,
        "equad_us": 0.0,
        "phase": 0.0,
        "jump": 0,
        "njumps": 0,
        "skip": False,
        "emax": None,
        "emin": None,
        "fmax": None,
        "fmin": None,
        "info": None,
        "fmt_tempo2": False,
    }
    _read_tim_into(path, toas, state, _depth)
    return toas


def _parse_flags(s: str) -> dict:
    """Parse the '-key value' tail of a tempo2 TOA line."""
    parts = s.split()
    flags = {}
    i = 0
    while i < len(parts):
        tok = parts[i]
        if tok.startswith("-") and not _is_number(tok):
            key = tok.lstrip("-")
            if i + 1 < len(parts):
                flags[key] = parts[i + 1]
                i += 2
            else:
                flags[key] = ""
                i += 1
        else:
            i += 1
    return flags


def _read_tim_into(path, toas, state, depth):
    if depth > 5:
        raise ValueError("INCLUDE nesting too deep")
    with open(path, "rb") as fb:
        text = fb.read()
    raw_lines = text.decode(errors="replace").split("\n")
    for raw in raw_lines:
        line = raw.rstrip("\r")
        if not line.strip():
            continue
        fmt = _toa_line_format(line, state["fmt_tempo2"])
        if fmt in ("Blank", "Comment"):
            continue
        if fmt == "Command":
            parts = line.split()
            cmd = parts[0].upper()
            arg = parts[1] if len(parts) > 1 else None
            if cmd == "FORMAT":
                state["fmt_tempo2"] = arg == "1"
            elif cmd == "MODE":
                pass  # MODE 1 (errors in us) is the only supported mode
            elif cmd == "TIME":
                state["time_offset_s"] += float(arg or 0.0)
            elif cmd == "EFAC":
                state["efac"] = float(arg or 1.0)
            elif cmd == "EQUAD":
                state["equad_us"] = float(arg or 0.0)
            elif cmd == "EMAX":
                state["emax"] = float(arg)
            elif cmd == "EMIN":
                state["emin"] = float(arg)
            elif cmd == "FMAX":
                state["fmax"] = float(arg)
            elif cmd == "FMIN":
                state["fmin"] = float(arg)
            elif cmd in ("PHASE", "PHA1", "PHA2"):
                state["phase"] += float(arg or 0.0)
            elif cmd == "JUMP":
                if state["jump"]:
                    state["jump"] = 0
                else:
                    state["njumps"] += 1
                    state["jump"] = state["njumps"]
            elif cmd == "SKIP":
                state["skip"] = True
            elif cmd == "NOSKIP":
                state["skip"] = False
            elif cmd == "INFO":
                state["info"] = arg
            elif cmd == "INCLUDE":
                sub = os.path.join(os.path.dirname(str(path)), arg)
                _read_tim_into(sub, toas, state, depth + 1)
            elif cmd == "END":
                return
            continue
        if state["skip"]:
            continue
        try:
            toa = _parse_line(line, fmt)
        except (ValueError, IndexError) as e:
            warnings.warn(f"skipping unparseable TOA line {line!r}: {e}")
            continue
        if state["emax"] is not None and toa.error_us > state["emax"]:
            continue
        if state["emin"] is not None and toa.error_us < state["emin"]:
            continue
        if state["fmax"] is not None and toa.freq_mhz > state["fmax"]:
            continue
        if state["fmin"] is not None and toa.freq_mhz < state["fmin"]:
            continue
        toa.error_us = toa.error_us * state["efac"]
        if state["equad_us"]:
            toa.error_us = float(
                np.hypot(toa.error_us, state["equad_us"])
            )
        if state["time_offset_s"]:
            toa.flags["to"] = repr(state["time_offset_s"])
        if state["phase"]:
            toa.flags["padd"] = repr(state["phase"])
        if state["jump"]:
            toa.flags["tim_jump"] = str(state["jump"])
        if state["info"]:
            toa.flags.setdefault("info", state["info"])
        toas.append(toa)


# --- host container ---------------------------------------------------------


class TOAs:
    """Host-side TOA table (struct of numpy arrays + python flag dicts)."""

    # class-level defaults for objects revived via object.__new__ paths
    # (merge); __init__ and get_TOAs set the real values
    include_clock = True
    include_bipm = False
    bipm_version = "BIPM2019"
    #: bucketing state (pint_tpu_torch.compile_cache): the real count of
    #: a padded object, the rows occupied by real or quarantined TOAs,
    #: and an explicit mask of the rows that count; None when unpadded
    n_real = None
    n_filled = None
    pad_valid = None
    #: the event file's row of each TOA, set by the photon loader
    #: (:func:`pint_tpu_torch.event_toas.load_event_TOAs`); None otherwise
    fits_rows = None

    def __init__(self, toa_list, ephem="builtin", planets=False,
                 include_clock=True, include_bipm=False,
                 bipm_version="BIPM2019"):
        if not toa_list:
            raise ValueError("no TOAs")
        self.ephem = ephem
        self.planets = planets
        # retained so re-reads (e.g. pintk's tim editor) can reproduce
        # the same clock/BIPM preparation
        self.include_clock = include_clock
        self.include_bipm = include_bipm
        self.bipm_version = bipm_version
        n = len(toa_list)
        self.flags = [dict(t.flags) for t in toa_list]
        self.names = [t.name for t in toa_list]
        self.error_us = np.array([t.error_us for t in toa_list])
        self.freq_mhz = np.array([t.freq_mhz for t in toa_list])
        self.freq_mhz[self.freq_mhz == 0.0] = np.inf  # 0 => infinite freq
        self.obs_names = [get_observatory(t.obs).name for t in toa_list]
        obs_unique = sorted(set(self.obs_names))
        self.obs_index = np.array(
            [obs_unique.index(o) for o in self.obs_names], dtype=np.int64
        )
        self.obs_list = obs_unique

        # clock corrections per observatory group (host, float64 seconds)
        mjd_float = np.array(
            [t.mjd_day + t.frac_num / t.frac_den for t in toa_list]
        )
        self.mjd_float = mjd_float
        clock = np.zeros(n)
        if include_clock:
            for io, oname in enumerate(obs_unique):
                obs = get_observatory(oname)
                m = self.obs_index == io
                if not obs.is_barycenter:
                    clock[m] = obs.clock_corrections_sec(mjd_float[m])
        # TT(BIPMxxxx) realization offsets ride the same additive path
        # (reference: bipm_correction, observatory/__init__.py:253)
        if include_bipm:
            from pint_tpu_torch.obs.clock import find_bipm_correction

            bipm = find_bipm_correction(bipm_version)
            if bipm is None:
                warnings.warn(
                    f"CLK TT({bipm_version}) requested but no "
                    "tai2tt_bipmXXXX.clk data found in "
                    "$PINT_TPU_CLOCK_DIR; using TT(TAI) (the BIPM "
                    "realization differs by ~27 us + slow drift)"
                )
            else:
                topo = np.array([
                    not get_observatory(o).is_barycenter
                    for o in self.obs_names])
                clock[topo] += bipm.evaluate_sec(mjd_float[topo])
        # TIME command offsets ride the clock path too
        for i, fl in enumerate(self.flags):
            if "to" in fl:
                clock[i] += float(fl["to"])
        self.clock_sec = clock

        # UTC(site)->TDB ticks (exact integer path per TOA)
        ticks = np.empty(n, dtype=np.int64)
        for i, t in enumerate(toa_list):
            obs = get_observatory(self.obs_names[i])
            scale = t.flags.get("timescale", "utc").lower()
            if scale not in ("utc", "tt", "tdb"):
                raise ValueError(
                    f"TOA {i}: unsupported -timescale {scale!r} "
                    "(utc|tt|tdb) — e.g. TIMESYS=TAI event files must "
                    "be converted first; silently treating it as UTC "
                    "would shift times by the ~37 s leap-second total"
                )
            if obs.is_barycenter or scale == "tdb":
                # already in the TDB scale (barycentered data, or photon
                # events with TIMESYS=TDB); TIME offsets still apply
                ticks[i] = mjd_to_ticks_tdb(
                    t.mjd_day, t.frac_num, t.frac_den
                ) + int(round(clock[i] * 2**32))
            elif scale == "tt":
                # photon-event TT (e.g. NICER MET): only the small
                # TDB-TT harmonic term remains
                from pint_tpu_torch.time.scales import tdb_minus_tt_seconds

                tt = mjd_to_ticks_tdb(t.mjd_day, t.frac_num, t.frac_den)
                dtdb = float(tdb_minus_tt_seconds(tt / 2**32))
                ticks[i] = tt + int(round(
                    (dtdb + clock[i]) * 2**32
                ))
            else:
                ticks[i] = mjd_to_ticks_utc(
                    t.mjd_day, t.frac_num, t.frac_den,
                    clock_offset_sec=clock[i],
                )
        self.ticks = ticks
        self._compute_posvels()

    def __len__(self):
        return len(self.flags)

    def _compute_posvels(self):
        """Observatory & solar-system geometry at each TOA (reference:
        toa.py:2323 compute_posvels)."""
        from pint_tpu_torch.ephem import body_posvel_ssb

        n = len(self)
        self.ssb_obs_pos = np.zeros((n, 3))
        self.ssb_obs_vel = np.zeros((n, 3))
        for io, oname in enumerate(self.obs_list):
            obs = get_observatory(oname)
            m = self.obs_index == io
            if getattr(obs, "needs_flags", False):
                fl = [f for f, take in zip(self.flags, m) if take]
                pv = obs.posvel_ssb(self.ticks[m], ephem=self.ephem,
                                    flags=fl)
            else:
                pv = obs.posvel_ssb(self.ticks[m], ephem=self.ephem)
            self.ssb_obs_pos[m] = pv.pos
            self.ssb_obs_vel[m] = pv.vel
        sun = body_posvel_ssb("sun", self.ticks, self.ephem)
        self.obs_sun_pos = sun.pos - self.ssb_obs_pos
        self.planet_pos = {}
        if self.planets:
            for b in ("venus", "mars", "jupiter", "saturn", "uranus", "neptune"):
                pv = body_posvel_ssb(b, self.ticks, self.ephem)
                self.planet_pos[b] = pv.pos - self.ssb_obs_pos

    # -- selection / merging (pint_tpu toa.py:535 __getitem__, :578
    # merge) -----------------------------------------------------------------
    def __getitem__(self, index):
        """Sub-TOAs by int, slice, boolean mask or integer array, with
        the prepared arrays sliced (no ingest runs again).  The result
        is unpadded: bucketing state is not carried."""
        n = len(self)
        if isinstance(index, (int, np.integer)):
            if not -n <= index < n:
                raise IndexError(index)
            idx = np.array([index % n])
        elif isinstance(index, slice):
            idx = np.arange(n)[index]
        else:
            idx = np.asarray(index)
            if idx.dtype == bool:
                if idx.shape != (n,):
                    raise IndexError(
                        f"boolean mask of shape {idx.shape} against "
                        f"{n} TOAs")
                idx = np.flatnonzero(idx)
            else:
                idx = idx.astype(np.int64)
        return self._sliced(idx)

    def _sliced(self, idx):
        new = object.__new__(TOAs)
        new.ephem = self.ephem
        new.planets = self.planets
        new.include_clock = self.include_clock
        new.include_bipm = self.include_bipm
        new.bipm_version = self.bipm_version
        new.flags = [dict(self.flags[i]) for i in idx]
        new.names = [self.names[i] for i in idx]
        for arr in ("error_us", "freq_mhz", "mjd_float", "clock_sec",
                    "ticks", "ssb_obs_pos", "ssb_obs_vel", "obs_sun_pos"):
            setattr(new, arr, getattr(self, arr)[idx])
        new.obs_names = [self.obs_names[i] for i in idx]
        obs_unique = sorted(set(new.obs_names))
        new.obs_index = np.array(
            [obs_unique.index(o) for o in new.obs_names], dtype=np.int64)
        new.obs_list = obs_unique
        new.planet_pos = {b: p[idx] for b, p in self.planet_pos.items()}
        return new

    @classmethod
    def merge(cls, toas_list):
        """Concatenate prepared TOAs objects (reference merge_TOAs,
        toa.py:2699).  All inputs must share ephem/planets settings."""
        if not toas_list:
            raise ValueError("nothing to merge")
        first = toas_list[0]
        for t in toas_list[1:]:
            if t.ephem != first.ephem or t.planets != first.planets:
                raise ValueError(
                    "cannot merge TOAs prepared with different "
                    f"ephem/planets settings: {t.ephem}/{t.planets} vs "
                    f"{first.ephem}/{first.planets}")
        new = object.__new__(cls)
        new.ephem = first.ephem
        new.planets = first.planets
        new.include_clock = first.include_clock
        new.include_bipm = first.include_bipm
        new.bipm_version = first.bipm_version
        new.flags = [dict(f) for t in toas_list for f in t.flags]
        new.names = [x for t in toas_list for x in t.names]
        for arr in ("error_us", "freq_mhz", "mjd_float", "clock_sec",
                    "ticks", "ssb_obs_pos", "ssb_obs_vel", "obs_sun_pos"):
            setattr(new, arr, np.concatenate(
                [getattr(t, arr) for t in toas_list]))
        new.obs_names = [x for t in toas_list for x in t.obs_names]
        obs_unique = sorted(set(new.obs_names))
        new.obs_index = np.array(
            [obs_unique.index(o) for o in new.obs_names], dtype=np.int64)
        new.obs_list = obs_unique
        new.planet_pos = {}
        if first.planets:
            for b in first.planet_pos:
                new.planet_pos[b] = np.concatenate(
                    [t.planet_pos[b] for t in toas_list])
        return new

    def get_flag_values(self, flag, default=None, astype=str):
        """Flag ``flag`` of every TOA as ``astype``, ``default`` where a
        TOA lacks it (pint_tpu toa.py:478)."""
        return [astype(f[flag]) if flag in f else default
                for f in self.flags]

    # -- pulse numbers (pint_tpu toa.py:481-510) ------------------------------
    def get_pulse_numbers(self):
        """Per-TOA absolute pulse numbers from ``-pn`` flags (float64,
        NaN where absent), or None when no TOA carries one."""
        if not any("pn" in f for f in self.flags):
            return None
        return np.array([float(f["pn"]) if "pn" in f else np.nan
                         for f in self.flags])

    def get_delta_pulse_numbers(self):
        """Accumulated PHASE-command / ``-padd`` phase offsets (turns),
        zero where absent."""
        return np.array([float(f.get("padd", 0.0)) for f in self.flags])

    def compute_pulse_numbers(self, model, device=None):
        """Assign ``-pn`` flags = the nearest-integer absolute pulse
        number under ``model`` (computed on ``device``, CUDA unless
        given): the anchor of TRACK -2 phase-connected fitting.  Returns
        the pulse numbers (int64)."""
        from pint_tpu_torch.residuals import Residuals

        r = Residuals(self, model, device=device, subtract_mean=False,
                      track_mode="nearest")
        with torch.no_grad():
            n, _ = r.prepared.phase()
        pn = n.cpu().numpy().astype(np.int64)
        for f, p in zip(self.flags, pn):
            f["pn"] = repr(int(p))
        return pn

    def to_table(self) -> "TOATable":
        """The columnar host table: flag keys sorted, each key's values
        sorted, -1 where a TOA lacks the key."""
        flags = {}
        for k in sorted({k for f in self.flags for k in f}):
            names = sorted({str(f[k]) for f in self.flags if k in f})
            lut = {n: i for i, n in enumerate(names)}
            flags[k] = (np.asarray(names, dtype=np.str_), np.asarray(
                [lut[str(f[k])] if k in f else -1 for f in self.flags],
                dtype=np.int32))
        return TOATable(
            ticks=np.asarray(self.ticks, np.int64),
            freq_mhz=np.asarray(self.freq_mhz, np.float64),
            error_us=np.asarray(self.error_us, np.float64),
            mjd_float=np.asarray(self.mjd_float, np.float64),
            ssb_obs_pos=np.asarray(self.ssb_obs_pos, np.float64),
            ssb_obs_vel=np.asarray(self.ssb_obs_vel, np.float64),
            obs_sun_pos=np.asarray(self.obs_sun_pos, np.float64),
            flags=flags)

    def to_batch(self, device) -> "TOABatch":
        """Device struct-of-arrays of :meth:`to_table`."""
        return self.to_table().to_batch(device)


def get_TOAs(timfile, ephem="builtin", planets=False, include_clock=True,
             include_bipm=False, bipm_version="BIPM2019") -> TOAs:
    """Parse and prepare TOAs from a .tim file (pint_tpu toa.py:737,
    without its on-disk cache)."""
    return TOAs(
        read_tim(timfile), ephem=ephem, planets=planets,
        include_clock=include_clock, include_bipm=include_bipm,
        bipm_version=bipm_version,
    )


# --- tables the device path reads --------------------------------------------


@dataclass
class TOATable:
    """Host-side TOA table.

    ticks: int64 TDB arrival time, 2^-32 s since J2000.
    Geometry in light-seconds / ls-per-s, ICRS axes: ssb_obs_pos,
    ssb_obs_vel, obs_sun_pos (N, 3).
    flags: {key: (names (n_k,) str, index (N,) int32)} — TOA i carries
    ``key = names[index[i]]``, or lacks the key where index is -1."""

    ticks: np.ndarray
    freq_mhz: np.ndarray
    error_us: np.ndarray
    mjd_float: np.ndarray
    ssb_obs_pos: np.ndarray
    ssb_obs_vel: np.ndarray
    obs_sun_pos: np.ndarray
    flags: Dict[str, Tuple[np.ndarray, np.ndarray]] = field(
        default_factory=dict)

    def __len__(self):
        return int(self.ticks.shape[0])

    def flag_equals(self, key, value) -> np.ndarray:
        """Boolean mask of TOAs whose flag ``key`` equals ``value``."""
        if key not in self.flags:
            return np.zeros(len(self), dtype=bool)
        names, index = self.flags[key]
        hit = np.flatnonzero(np.asarray(names) == str(value))
        if hit.size == 0:
            return np.zeros(len(self), dtype=bool)
        return np.asarray(index) == int(hit[0])

    def _flag_floats(self, key, missing):
        """Flag ``key`` per TOA as float64, ``missing`` where absent."""
        names, index = self.flags[key]
        vals = np.array([float(n) for n in names] + [missing])
        return vals[np.where(np.asarray(index) >= 0, index, len(names))]

    def get_pulse_numbers(self):
        """Per-TOA absolute pulse numbers from ``-pn`` flags (float64,
        NaN where absent), or None when no TOA carries one."""
        if "pn" not in self.flags:
            return None
        return self._flag_floats("pn", np.nan)

    def get_delta_pulse_numbers(self):
        """Accumulated PHASE-command / ``-padd`` phase offsets (turns),
        zero where absent."""
        if "padd" not in self.flags:
            return np.zeros(len(self))
        return self._flag_floats("padd", 0.0)

    def to_batch(self, device) -> "TOABatch":
        dev = torch.device(device)

        def t(a, dtype=torch.float64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        return TOABatch(
            ticks=t(self.ticks, torch.int64),
            freq_mhz=t(self.freq_mhz),
            error_s=t(self.error_us * 1e-6),
            ssb_obs_pos=t(self.ssb_obs_pos),
            ssb_obs_vel=t(self.ssb_obs_vel),
            obs_sun_pos=t(self.obs_sun_pos),
            planet_pos=torch.zeros((0, len(self), 3), dtype=torch.float64,
                                   device=dev),
        )


@dataclass
class TOABatch:
    """Device struct-of-arrays TOA batch (pint_tpu toa.py:635-651).
    planet_pos is (6, N, 3) for venus..neptune, or empty when planets
    were not loaded."""

    ticks: torch.Tensor
    freq_mhz: torch.Tensor
    error_s: torch.Tensor
    ssb_obs_pos: torch.Tensor
    ssb_obs_vel: torch.Tensor
    obs_sun_pos: torch.Tensor
    planet_pos: Optional[torch.Tensor]

    def __len__(self):
        return int(self.ticks.shape[0])
