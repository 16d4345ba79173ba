"""Minimal FITS reader/writer for event binary tables.

Counterpart of ``pint_tpu/io/fits.py`` (the astropy.io.fits capability
PINT uses for event and orbit files), only what event files and
satellite orbit tables need: header parsing, BINTABLE column decode
(logical/byte/short/int/long/float/double/string TFORMs), writing a
binary table, and appending a column (``add_column``).

FITS structure: 2880-byte blocks; headers are 80-char cards; binary
tables are big-endian packed rows described by TFORMn codes.
"""

from __future__ import annotations

import numpy as np

BLOCK = 2880
CARD = 80

_TFORM_DTYPES = {
    "L": ("S1", 1), "B": (">u1", 1), "I": (">i2", 2), "J": (">i4", 4),
    "K": (">i8", 8), "E": (">f4", 4), "D": (">f8", 8), "A": ("S", 1),
}


def _parse_header_block(data, off):
    """Parse cards until END; returns (dict, new offset, card list)."""
    cards = []
    hdr: dict = {}
    while True:
        block = data[off:off + BLOCK]
        if len(block) < BLOCK:
            raise ValueError("truncated FITS header")
        off += BLOCK
        done = False
        for i in range(0, BLOCK, CARD):
            card = block[i:i + CARD].decode("ascii", "replace")
            cards.append(card)
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if not key or key in ("COMMENT", "HISTORY") or card[8] != "=":
                continue
            val = card[10:].split("/")[0].strip()
            if val.startswith("'"):
                hdr[key] = val.strip("'").strip()
            elif val in ("T", "F"):
                hdr[key] = val == "T"
            else:
                try:
                    hdr[key] = int(val)
                except ValueError:
                    try:
                        hdr[key] = float(val)
                    except ValueError:
                        hdr[key] = val
        if done:
            break
    return hdr, off, cards


def _data_size(hdr):
    """FITS standard: |BITPIX|/8 * GCOUNT * (PCOUNT + prod(NAXISi))."""
    bitpix = abs(int(hdr.get("BITPIX", 8)))
    naxis = int(hdr.get("NAXIS", 0))
    if naxis == 0:
        return 0
    n = 1
    for i in range(1, naxis + 1):
        n *= int(hdr.get(f"NAXIS{i}", 0))
    gcount = int(hdr.get("GCOUNT", 1))
    pcount = int(hdr.get("PCOUNT", 0))
    return bitpix // 8 * gcount * (pcount + n)


def _parse_tform(tform: str):
    tform = tform.strip()
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    repeat = int(tform[:i]) if i else 1
    code = tform[i]
    return repeat, code


class HDU:
    def __init__(self, header, cards, data_bytes):
        self.header = header
        self.cards = cards
        self._data = data_bytes

    @property
    def name(self):
        return str(self.header.get("EXTNAME", "")).strip()

    def is_bintable(self):
        return self.header.get("XTENSION", "").strip() == "BINTABLE"

    def columns(self):
        n = int(self.header.get("TFIELDS", 0))
        return [
            str(self.header.get(f"TTYPE{i}", f"col{i}")).strip()
            for i in range(1, n + 1)
        ]

    def _layout(self):
        nfields = int(self.header["TFIELDS"])
        offs, dtypes, names = [], [], []
        off = 0
        for i in range(1, nfields + 1):
            repeat, code = _parse_tform(str(self.header[f"TFORM{i}"]))
            base, size = _TFORM_DTYPES[code]
            offs.append(off)
            if code == "A":
                dtypes.append((f"S{repeat}", 1))
            else:
                dtypes.append((base, repeat))
            names.append(str(self.header.get(f"TTYPE{i}", f"col{i}")).strip())
            off += repeat * size
        rowlen = int(self.header["NAXIS1"])
        if off > rowlen:
            raise ValueError("TFORM row length exceeds NAXIS1")
        return names, offs, dtypes, rowlen

    def column(self, name):
        """Column data as a numpy array (nrows,) or (nrows, repeat)."""
        names, offs, dtypes, rowlen = self._layout()
        nrows = int(self.header["NAXIS2"])
        try:
            i = [n.upper() for n in names].index(str(name).upper())
        except ValueError:
            raise KeyError(
                f"no column {name!r} in {self.name}; have {names}"
            )
        raw = np.frombuffer(
            self._data[: nrows * rowlen], dtype=np.uint8
        ).reshape(nrows, rowlen)
        dt, repeat = dtypes[i]
        itemsize = np.dtype(dt).itemsize
        chunk = raw[:, offs[i]: offs[i] + itemsize * repeat]
        out = chunk.reshape(-1).view(dt).reshape(nrows, repeat)
        if dt.startswith("S"):
            return np.char.strip(out[:, 0].astype(str))
        out = out.astype(out.dtype.newbyteorder("="))
        return out[:, 0] if repeat == 1 else out


def read_fits(path) -> list[HDU]:
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"SIMPLE"):
        raise ValueError(f"{path}: not a FITS file")
    hdus = []
    off = 0
    while off < len(data):
        hdr, off, cards = _parse_header_block(data, off)
        size = _data_size(hdr)
        padded = (size + BLOCK - 1) // BLOCK * BLOCK
        hdus.append(HDU(hdr, cards, data[off:off + size]))
        off += padded
    return hdus


def get_bintable(path, extname=None) -> HDU:
    """First BINTABLE HDU (or the named one)."""
    for h in read_fits(path):
        if not h.is_bintable():
            continue
        if extname is None or h.name.upper() == str(extname).upper():
            return h
    raise ValueError(f"no BINTABLE {extname or ''} in {path}")


# -- writing (event files for tests + PULSE_PHASE output) -----------------
def _card(key, value, comment=""):
    if isinstance(value, bool):
        v = "T" if value else "F"
        s = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        s = f"{key:<8}= {value:>20d}"
    elif isinstance(value, float):
        s = f"{key:<8}= {value:>20.13E}"
    else:
        s = f"{key:<8}= '{value}'"
    if comment:
        s += f" / {comment}"
    return s[:CARD].ljust(CARD)


def _pad_block(b: bytes, fill=b"\x00") -> bytes:
    rem = len(b) % BLOCK
    return b if rem == 0 else b + fill * (BLOCK - rem)


def write_event_fits(path, columns: dict, header_extra: dict = None,
                     extname: str = "EVENTS"):
    """Write a minimal FITS file: empty primary HDU + one BINTABLE with
    float64 (D), float32 (E), int32 (J) or string (A) columns inferred
    from the arrays."""
    cards = [
        _card("SIMPLE", True), _card("BITPIX", 8), _card("NAXIS", 0),
        _card("EXTEND", True), "END".ljust(CARD),
    ]
    primary = _pad_block("".join(cards).encode("ascii"), b" ")

    names = list(columns)
    arrays = []
    tforms = []
    for n in names:
        a = np.asarray(columns[n])
        if a.dtype.kind == "f" and a.dtype.itemsize == 4:
            arrays.append(a.astype(">f4"))
            tforms.append("1E")
        elif a.dtype.kind == "f":
            arrays.append(a.astype(">f8"))
            tforms.append("1D")
        elif a.dtype.kind in "iu":
            arrays.append(a.astype(">i4"))
            tforms.append("1J")
        else:
            width = max(1, max((len(str(s)) for s in a), default=1))
            arrays.append(np.asarray(
                [str(s).ljust(width).encode() for s in a], dtype=f"S{width}"
            ))
            tforms.append(f"{width}A")
    nrows = len(arrays[0])
    rowlen = sum(a.dtype.itemsize for a in arrays)
    tcards = [
        _card("XTENSION", "BINTABLE"), _card("BITPIX", 8),
        _card("NAXIS", 2), _card("NAXIS1", rowlen),
        _card("NAXIS2", nrows), _card("PCOUNT", 0), _card("GCOUNT", 1),
        _card("TFIELDS", len(names)), _card("EXTNAME", extname),
    ]
    for i, (n, tf) in enumerate(zip(names, tforms), start=1):
        tcards.append(_card(f"TTYPE{i}", n))
        tcards.append(_card(f"TFORM{i}", tf))
    for k, v in (header_extra or {}).items():
        tcards.append(_card(k, v))
    tcards.append("END".ljust(CARD))
    theader = _pad_block("".join(tcards).encode("ascii"), b" ")

    rows = np.empty((nrows, rowlen), dtype=np.uint8)
    off = 0
    for a in arrays:
        size = a.dtype.itemsize
        rows[:, off:off + size] = a.reshape(nrows, 1).view(np.uint8).reshape(
            nrows, size
        )
        off += size
    tdata = _pad_block(rows.tobytes())

    with open(path, "wb") as f:
        f.write(primary)
        f.write(theader)
        f.write(tdata)


def add_column(path, out_path, name, values, extname=None):
    """Copy the file with an extra column appended to the (first or
    named) BINTABLE, keeping its timing keywords (photonphase writes
    PULSE_PHASE back into the event file this way)."""
    hdu = get_bintable(path, extname)
    cols = {n: hdu.column(n) for n in hdu.columns()}
    cols[name] = np.asarray(values)
    extra = {
        k: hdu.header[k]
        for k in hdu.header
        if k in (
            "MJDREFI", "MJDREFF", "MJDREF", "TIMEZERO", "TIMESYS",
            "TELESCOP", "INSTRUME", "OBS_ID",
        )
    }
    write_event_fits(
        out_path, cols, header_extra=extra, extname=hdu.name or "EVENTS"
    )
