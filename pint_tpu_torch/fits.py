"""Minimal FITS binary-table reader and event writer (pure numpy), the
port's own copy of ``pint_tpu.fits``.

Counterpart of the reference's use of ``astropy.io.fits`` for photon
event files (reference: src/pint/fits_utils.py:1-127
``read_fits_event_mjds_tuples``, src/pint/event_toas.py).  Implements
exactly the subset the photon path needs: 2880-byte header blocks,
keyword cards, and BINTABLE extensions with scalar numeric columns
(big-endian, as the standard requires).
"""

from __future__ import annotations

import numpy as np

__all__ = ["FitsHDU", "read_fits", "read_events", "write_events"]

_BLOCK = 2880
_CARD = 80

#: TFORM letter -> numpy big-endian dtype
_TFORM = {
    "L": "i1", "B": "u1", "I": ">i2", "J": ">i4", "K": ">i8",
    "E": ">f4", "D": ">f8",
}


class FitsHDU:
    def __init__(self, header, data=None, columns=None):
        self.header = header
        self.data = data  # dict column name -> array (tables)
        self.columns = columns or []

    @property
    def name(self):
        return str(self.header.get("EXTNAME", "")).strip()


def _parse_header(chunk_iter):
    """Consume header blocks; return (header dict, bytes consumed)."""
    header = {}
    nbytes = 0
    done = False
    while not done:
        block = next(chunk_iter)
        nbytes += _BLOCK
        for i in range(0, _BLOCK, _CARD):
            card = block[i:i + _CARD].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if not key or card[8] != "=":
                continue
            val = card[10:]
            # strip inline comment (respect quoted strings)
            if val.lstrip().startswith("'"):
                s = val.lstrip()[1:]
                out = []
                j = 0
                while j < len(s):
                    if s[j] == "'":
                        if j + 1 < len(s) and s[j + 1] == "'":
                            out.append("'")
                            j += 2
                            continue
                        break
                    out.append(s[j])
                    j += 1
                header[key] = "".join(out).rstrip()
                continue
            val = val.split("/")[0].strip()
            if val in ("T", "F"):
                header[key] = val == "T"
            else:
                try:
                    header[key] = int(val)
                except ValueError:
                    try:
                        header[key] = float(val)
                    except ValueError:
                        header[key] = val
    return header, nbytes


def read_fits(path):
    """Read all HDUs; table HDUs get a {column: ndarray} data dict."""
    with open(path, "rb") as f:
        raw = f.read()
    hdus = []
    pos = 0

    def blocks():
        nonlocal pos
        while pos < len(raw):
            b = raw[pos:pos + _BLOCK]
            pos += _BLOCK
            yield b

    it = blocks()
    while pos < len(raw):
        try:
            header, _ = _parse_header(it)
        except StopIteration:
            break
        bitpix = abs(int(header.get("BITPIX", 8)))
        naxes = [
            int(header.get(f"NAXIS{i + 1}", 0))
            for i in range(int(header.get("NAXIS", 0)))
        ]
        datasize = (
            bitpix // 8 * int(np.prod(naxes)) if naxes else 0
        ) * max(1, int(header.get("GCOUNT", 1)))
        datasize += int(header.get("PCOUNT", 0)) * bitpix // 8
        data = None
        columns = []
        if header.get("XTENSION", "").startswith("BINTABLE") and naxes:
            row_bytes, nrows = naxes[0], naxes[1]
            table_raw = raw[pos:pos + row_bytes * nrows]
            ncols = int(header.get("TFIELDS", 0))
            data = {}
            offset = 0
            for c in range(1, ncols + 1):
                tform = str(header.get(f"TFORM{c}", "")).strip()
                ttype = str(header.get(f"TTYPE{c}", f"COL{c}")).strip()
                # repeat count + letter (e.g. '1D', 'D', '2E')
                rep = ""
                j = 0
                while j < len(tform) and tform[j].isdigit():
                    rep += tform[j]
                    j += 1
                letter = tform[j:j + 1]
                repeat = int(rep) if rep else 1
                columns.append(ttype)
                if letter in _TFORM:
                    dt = np.dtype(_TFORM[letter])
                    width = dt.itemsize * repeat
                    arr = np.ndarray(
                        (nrows, repeat), dtype=dt,
                        buffer=table_raw,
                        offset=offset,
                        strides=(row_bytes, dt.itemsize),
                    )
                    arr = arr.astype(dt.newbyteorder("="))
                    data[ttype] = arr[:, 0] if repeat == 1 else arr
                elif letter == "A":
                    width = repeat
                    arr = np.ndarray(
                        (nrows,), dtype=f"S{repeat}",
                        buffer=table_raw, offset=offset,
                        strides=(row_bytes,),
                    )
                    data[ttype] = np.char.decode(arr, "ascii")
                elif letter == "X":
                    # bit array (e.g. Fermi FT1 EVENT_CLASS '32X'):
                    # ceil(repeat/8) bytes per row, kept as raw uint8
                    width = (repeat + 7) // 8
                    arr = np.ndarray(
                        (nrows, width), dtype=np.uint8,
                        buffer=table_raw, offset=offset,
                        strides=(row_bytes, 1),
                    )
                    data[ttype] = arr.copy()
                else:
                    raise ValueError(
                        f"unsupported TFORM {tform!r} for {ttype}"
                    )
                offset += width
        # skip data (padded to block size)
        pos += (datasize + _BLOCK - 1) // _BLOCK * _BLOCK
        hdus.append(FitsHDU(header, data, columns))
    return hdus


def read_events(path, extname="EVENTS", columns=None):
    """(header, {column: array}) of the named table extension."""
    for hdu in read_fits(path):
        if hdu.data is not None and hdu.name.upper() == extname.upper():
            if columns:
                missing = [c for c in columns if c not in hdu.data]
                if missing:
                    raise KeyError(
                        f"columns {missing} not in {extname} "
                        f"(has {list(hdu.data)})"
                    )
            return hdu.header, hdu.data
    raise KeyError(f"no {extname} extension in {path}")


def write_events(path, time_s, mjdref=(56000, 0.0), timesys="TDB",
                 timeref="SOLARSYSTEM", extra_cols=None,
                 extname="EVENTS", extra_header=None, timezero=0.0):
    """Minimal standards-compliant event-FITS writer: empty primary HDU
    + one BINTABLE with a TIME column (f64 MET seconds) and optional
    extra f64 columns (reference analogue: photonphase --outfile, which
    writes PULSE_PHASE/ORBIT_PHASE columns via astropy.io.fits;
    scripts/photonphase.py:90).  extra_header: additional scalar cards
    for the table header."""

    def card(key, val, quote=False):
        if quote:
            v = f"'{val}'"
        elif isinstance(val, bool):
            v = "T" if val else "F"
        else:
            v = str(val)
        return f"{key:<8s}= {v:>20s}{'':50s}"[:80].encode()

    def block(cards):
        data = b"".join(cards) + b"END" + b" " * 77
        return data + b" " * ((-len(data)) % _BLOCK)

    primary = block([
        card("SIMPLE", True), card("BITPIX", 8), card("NAXIS", 0),
    ])
    cols = [("TIME", np.asarray(time_s, dtype=">f8"))]
    for name, arr in (extra_cols or {}).items():
        cols.append((name, np.asarray(arr, dtype=">f8")))
    nrows = len(time_s)
    row_bytes = 8 * len(cols)
    cards = [
        card("XTENSION", "BINTABLE", quote=True),
        card("BITPIX", 8), card("NAXIS", 2),
        card("NAXIS1", row_bytes), card("NAXIS2", nrows),
        card("PCOUNT", 0), card("GCOUNT", 1),
        card("TFIELDS", len(cols)),
        card("EXTNAME", extname, quote=True),
        card("MJDREFI", mjdref[0]), card("MJDREFF", mjdref[1]),
        card("TIMESYS", timesys, quote=True),
        card("TIMEREF", timeref, quote=True),
        card("TIMEZERO", float(timezero)),
    ]
    for key, val in (extra_header or {}).items():
        cards.append(card(key, val, quote=isinstance(val, str)))
    for i, (name, _) in enumerate(cols, start=1):
        cards.append(card(f"TTYPE{i}", name, quote=True))
        cards.append(card(f"TFORM{i}", "D", quote=True))
    table = np.empty((nrows, len(cols)), dtype=">f8")
    for i, (_, arr) in enumerate(cols):
        table[:, i] = arr
    raw = table.tobytes()
    raw += b"\x00" * ((-len(raw)) % _BLOCK)
    with open(path, "wb") as f:
        f.write(primary + block(cards) + raw)
