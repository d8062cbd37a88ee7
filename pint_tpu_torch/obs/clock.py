"""Clock correction files: tempo2 and TEMPO formats.

Behavioral counterpart of the reference's ClockFile (reference:
src/pint/observatory/clock_file.py:441,566): parses both community formats,
evaluates by linear interpolation with an out-of-range policy, and chains
files (site -> GPS -> UTC etc.).  Nothing is downloaded (the reference
fetches the IPTA clock-corrections repo at runtime): files are
discovered by conventional names in $PINT_TORCH_CLOCK_DIR, ./clock and
the JAX package's bundled pint_tpu/data/runtime.

- tempo2 format (``*.clk``): ``# FROM TO`` header line, then
  ``mjd offset_seconds [...]`` rows.
- TEMPO format (``time*.dat``): fixed columns — MJD in [0:9],
  clkcorr1 (us) in [9:21], clkcorr2 (us) in [21:33], one-char site code at
  column 34; correction = clkcorr2 - clkcorr1; the historical
  ``clkcorr1 > 800 -> -818.8`` tempo adjustment is applied.
"""

from __future__ import annotations

import os
import warnings

import numpy as np


class ClockFile:
    """MJD-indexed clock offsets [s] with linear interpolation."""

    def __init__(self, mjds, offsets_sec, name="", limits="warn"):
        mjds = np.asarray(mjds, dtype=np.float64)
        offsets_sec = np.asarray(offsets_sec, dtype=np.float64)
        # a corrupted tabulation must fail loudly: 'nan'/'inf' parse as
        # valid floats, and np.interp would silently smear a single
        # NaN row across every TOA in its neighborhood
        bad = ~(np.isfinite(mjds) & np.isfinite(offsets_sec))
        if bad.any():
            raise ValueError(
                f"clock file {name or '<anonymous>'}: "
                f"{int(bad.sum())} non-finite MJD/offset row(s) "
                f"(first at index {int(np.flatnonzero(bad)[0])}) — a "
                "corrupted table must not silently interpolate")
        order = np.argsort(mjds, kind="stable")
        self.mjds = mjds[order]
        self.offsets = offsets_sec[order]
        self.name = name
        self.limits = limits
        self._warned = False

    def evaluate_sec(self, mjd):
        mjd = np.asarray(mjd, dtype=np.float64)
        if self.mjds.size == 0:
            return np.zeros_like(mjd)
        out_of_range = (mjd < self.mjds[0]) | (mjd > self.mjds[-1])
        if np.any(out_of_range):
            msg = (
                f"clock file {self.name}: {int(out_of_range.sum())} MJDs "
                f"outside coverage [{self.mjds[0]}, {self.mjds[-1]}]"
            )
            if self.limits == "error":
                raise ValueError(msg)
            if not self._warned:
                warnings.warn(msg + "; clamping to end values")
                self._warned = True
        return np.interp(mjd, self.mjds, self.offsets)

    # -- parsers -------------------------------------------------------------
    @classmethod
    def read_tempo2(cls, path, limits="warn"):
        mjds, offs = [], []
        with open(path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                parts = line.split()
                try:
                    mjd = float(parts[0])
                    off = float(parts[1])
                except (ValueError, IndexError):
                    continue
                mjds.append(mjd)
                offs.append(off)
        if not mjds:
            raise ValueError(
                f"clock file {path}: no parseable 'MJD offset' rows — "
                "a present-but-garbage file must not silently mean "
                "zero corrections")
        return cls(mjds, offs, name=os.path.basename(path), limits=limits)

    @classmethod
    def read_tempo(cls, path, site_code=None, limits="warn"):
        mjds, offs = [], []
        with open(path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                first = line.split()[0].upper() if line.split() else ""
                if first.startswith("MJD") or first.startswith("====="):
                    continue
                try:
                    mjd = float(line[:9])
                except (ValueError, IndexError):
                    continue
                if (mjd < 39000 and mjd != 0) or mjd > 100000:
                    continue

                def _field(a, b):
                    try:
                        return float(line[a:b])
                    except (ValueError, IndexError):
                        return None

                c1 = _field(9, 21)
                c2 = _field(21, 33)
                if c1 is None and c2 is None:
                    continue
                csite = line[34].lower() if len(line) > 34 else None
                if site_code is not None and csite != site_code.lower():
                    continue
                c1 = c1 or 0.0
                c2 = c2 or 0.0
                if c1 > 800.0:  # historical tempo convention
                    c1 -= 818.8
                mjds.append(mjd)
                offs.append((c2 - c1) * 1e-6)  # us -> s
        return cls(mjds, offs, name=os.path.basename(path), limits=limits)

    @classmethod
    def read(cls, path, fmt=None, **kw):
        if fmt is None:
            fmt = "tempo2" if str(path).endswith(".clk") else "tempo"
        if fmt == "tempo2":
            kw.pop("site_code", None)
            return cls.read_tempo2(path, **kw)
        return cls.read_tempo(path, **kw)

    # -- writers (reference: clock_file.py:295 write_tempo2_clock_file,
    # :355 write_tempo_clock_file) -------------------------------------------
    def write_tempo2(self, path, hdr_from="SITE", hdr_to="UTC(GPS)",
                     comments=""):
        with open(path, "w") as f:
            f.write(f"# {hdr_from} {hdr_to}\n")
            if comments:
                for ln in comments.splitlines():
                    f.write(f"# {ln}\n")
            for m, o in zip(self.mjds, self.offsets):
                f.write(f"{m:.6f} {o:.12e}\n")

    def write_tempo(self, path, site_code="1", comments=""):
        """TEMPO fixed-column time.dat format: the correction is stored
        in the clkcorr2 column (us), clkcorr1 = 0."""
        with open(path, "w") as f:
            f.write("# MJD       clkcorr1(us)  clkcorr2(us) s\n")
            if comments:
                for ln in comments.splitlines():
                    f.write(f"# {ln}\n")
            for m, o in zip(self.mjds, self.offsets):
                f.write(f"{m:9.2f}{0.0:12.3f}{o*1e6:12.4f} "
                        f"{site_code[:1]}\n")

    # -- combination (reference: clock_file.py merge) ------------------------
    @staticmethod
    def merge(clocks, trim=True):
        """One ClockFile whose corrections are the *sum* of the inputs
        (e.g. ao2gps + gps2utc -> ao2utc).  Discontinuities (repeated
        MJDs) in any input are propagated; with trim, coverage is the
        intersection of the inputs' ranges."""
        if not clocks:
            raise ValueError("nothing to merge")
        all_mjds = []
        discont = set()
        for c in clocks:
            all_mjds.append(c.mjds)
            dup = c.mjds[:-1][np.diff(c.mjds) == 0]
            discont.update(dup.tolist())
        mjds = np.unique(np.concatenate(all_mjds))
        rep = np.ones(len(mjds), dtype=int)
        for m in discont:
            rep[np.searchsorted(mjds, m)] = 2
        mjds = np.repeat(mjds, rep)
        total = np.zeros(len(mjds))
        for c in clocks:
            vals = np.interp(mjds, c.mjds, c.offsets)
            # at a discontinuity (repeated mjd), the left copy takes the
            # pre-jump value and the right copy the post-jump value
            dup_left = np.flatnonzero(np.diff(mjds) == 0)
            for i in dup_left:
                m = mjds[i]
                j = np.searchsorted(c.mjds, m)
                if j < len(c.mjds) - 1 and c.mjds[j] == c.mjds[j + 1]:
                    vals[i] = c.offsets[j]
                    vals[i + 1] = c.offsets[j + 1]
            total += vals
        lo = max(c.mjds[0] for c in clocks)
        hi = min(c.mjds[-1] for c in clocks)
        if trim:
            keep = (mjds >= lo) & (mjds <= hi)
            mjds, total = mjds[keep], total[keep]
        out = ClockFile.__new__(ClockFile)
        out.mjds = mjds
        out.offsets = total
        out.name = "+".join(c.name or "?" for c in clocks)
        out.limits = clocks[0].limits
        out._warned = False
        return out


class GlobalClockFile(ClockFile):
    """A registry-backed clock file that transparently refreshes when
    the underlying file changes on disk.

    The reference's GlobalClockFile (clock_file.py:781) re-downloads
    from the IPTA clock-corrections repository when TOAs fall past the
    end of the current version; here nothing is downloaded, and the
    refresh trigger is a file-mtime change in $PINT_TORCH_CLOCK_DIR
    instead (drop in an updated file and running processes pick it up)."""

    def __init__(self, filename, fmt=None, site_code=None, limits="warn"):
        self.filename = filename
        self.fmt = fmt
        self.site_code = site_code
        self._mtime = None
        self._reload(limits)

    def _reload(self, limits="warn"):
        base = ClockFile.read(self.filename, fmt=self.fmt,
                              site_code=self.site_code, limits=limits)
        self.mjds = base.mjds
        self.offsets = base.offsets
        self.name = base.name
        self.limits = base.limits
        self._warned = False
        self._mtime = os.stat(self.filename).st_mtime_ns

    def evaluate_sec(self, mjd):
        try:
            if os.stat(self.filename).st_mtime_ns != self._mtime:
                self._reload(self.limits)
        except OSError:
            pass
        return super().evaluate_sec(mjd)


def _clock_dirs():
    from pint_tpu_torch.obs.datadirs import search_dirs

    return search_dirs("PINT_TORCH_CLOCK_DIR", "clock",
                       include_builtin=True)


def find_clock_file(filename, fmt=None, site_code=None):
    """Locate one clock file by name in $PINT_TORCH_CLOCK_DIR / ./clock
    (reference: observatory/__init__.py:867 find_clock_file, minus the
    network repository).  Returns a GlobalClockFile or None."""
    for d in _clock_dirs():
        path = os.path.join(d, filename)
        if os.path.exists(path):
            return GlobalClockFile(path, fmt=fmt, site_code=site_code)
    return None


def find_clock_chain(obs):
    """Locate the clock chain for a TopoObs.

    Per-site clock-file specs (obs.clock_files, mirroring the
    reference's observatories.json clock_file entries) are honored
    first; otherwise conventional names are tried: <name>2gps.clk +
    gps2utc.clk, or time_<name>.dat (tempo).  Returns a (possibly
    empty) list of ClockFile."""
    chain = []
    for spec in getattr(obs, "clock_files", ()) or ():
        if isinstance(spec, str):
            spec = {"name": spec}
        cf = find_clock_file(spec["name"], fmt=spec.get("format"),
                             site_code=spec.get("site",
                                                obs.tempo_code))
        if cf is not None:
            chain.append(cf)
    if chain:
        gps = find_clock_file("gps2utc.clk", fmt="tempo2")
        if gps is not None:
            chain.append(gps)
        return chain
    for d in _clock_dirs():
        site_files = [
            (os.path.join(d, f"{obs.name}2gps.clk"), "tempo2", None),
        ]
        if obs.tempo_code:
            # generic tempo files are keyed by site code: a site
            # without one (e.g. the IPTA-MDC fake 'axis') must not
            # absorb every site's entries via an unfiltered read
            site_files += [
                (os.path.join(d, f"time_{obs.name}.dat"), "tempo",
                 obs.tempo_code),
                (os.path.join(d, "time.dat"), "tempo", obs.tempo_code),
            ]
        for path, fmt, site in site_files:
            if os.path.exists(path):
                chain.append(GlobalClockFile(path, fmt=fmt,
                                             site_code=site))
                break
        if chain:
            break
    if chain:
        # GPS->UTC may live in a different search dir than the site
        # file (e.g. a user site file in ./clock over the bundled
        # gps2utc.clk): search all dirs
        gps = find_clock_file("gps2utc.clk", fmt="tempo2")
        if gps is not None:
            chain.append(gps)
    return chain


#: TT - TAI, seconds, exact by definition
_TT_MINUS_TAI = 32.184


def find_bipm_correction(version="BIPM2019"):
    """TT(BIPMxxxx) - TT(TAI) realization offsets as a ClockFile
    (reference: observatory/__init__.py:253 bipm_correction reading
    tai2tt_bipmXXXX.clk), or None when the data file is absent.  Falls
    back to the latest available earlier realization, like the
    reference's find_latest_bipm (:70).

    The published tai2tt_bipm*.clk files tabulate TT(BIPM) - TAI
    (~32.1843 s); the 32.184 s of TT(TAI) - TAI is subtracted here —
    exactly as the reference does — leaving the ~27 us realization
    offset."""
    version = version.upper().replace("TT(", "").replace(")", "")
    want = int(version.replace("BIPM", "") or 2019)
    best = None
    for d in _clock_dirs():
        for f in os.listdir(d):
            m = f.lower()
            if m.startswith("tai2tt_bipm") and m.endswith(".clk"):
                try:
                    yr = int(m[len("tai2tt_bipm"):-len(".clk")])
                except ValueError:
                    continue
                if yr <= want and (best is None or yr > best[0]):
                    best = (yr, os.path.join(d, f))
    if best is None:
        return None
    cf = GlobalClockFile(best[1], fmt="tempo2")
    cf.offsets = cf.offsets - _TT_MINUS_TAI
    # keep the subtraction across mtime refreshes
    orig_reload = cf._reload

    def _reload(limits="warn"):
        orig_reload(limits)
        cf.offsets = cf.offsets - _TT_MINUS_TAI

    cf._reload = _reload
    return cf
