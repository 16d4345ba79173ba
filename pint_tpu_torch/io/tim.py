"""Tim-file (TOA) parsing and writing.

Counterpart of ``pint_tpu/io/tim.py`` (PINT's toa.py tim parsing):
Tempo2 ("FORMAT 1") and Princeton formats, tim commands (FORMAT, MODE, INCLUDE, TIME, EFAC,
EQUAD, EMIN, SKIP/NOSKIP, END, PHASE, JUMP), per-TOA flags (-key value).

Princeton fixed columns (tempo convention):
  col 0     observatory one-character code
  col 1-:   free text name
  cols 15+  freq (MHz), MJD (cols 24-44), uncertainty (us)
We parse Princeton leniently by whitespace after extracting the site code,
which covers the files produced by tempo/PINT writers; ITOA/Parkes formats
raise a clear error (rare in modern datasets).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pint_tpu_torch.exceptions import PintTpuError
from pint_tpu_torch.timebase.times import TimeArray
from pint_tpu_torch.toas.toas import TOAs

__all__ = ["read_tim_file", "write_tim_file"]

_COMMANDS = {
    "FORMAT", "MODE", "INCLUDE", "TIME", "EFAC", "EQUAD", "EMIN", "EMAX",
    "SKIP", "NOSKIP", "END", "PHASE", "JUMP", "TRACK", "INFO", "FMIN",
    "FMAX", "SIGMA",
}


def _is_flag_key(tok: str) -> bool:
    """'-f', '-be' are flag keys; '-1', '-0.5' are (negative) values."""
    return len(tok) >= 2 and tok[0] == "-" and not tok[1].isdigit() \
        and tok[1] != "."


class _ParseState:
    def __init__(self):
        self.fmt = "Princeton"
        self.time_offset_s = 0.0
        self.efac = 1.0
        self.equad_us = 0.0
        self.emin_us = None
        self.emax_us = None
        self.fmin_mhz = None
        self.fmax_mhz = None
        self.phase = 0.0
        self.skip = False
        self.jump_counter = 0
        self.in_jump = False
        self.ended = False


def read_tim_file(path, include_depth: int = 0, state: "_ParseState" = None):
    """-> raw row dict (pre-TOAs).  ``state`` is shared across INCLUDE
    (tempo2 semantics: FORMAT/EFAC/TIME... in force carry into included
    files and mutations inside them persist after return)."""
    if include_depth > 10:
        raise PintTpuError("INCLUDE nesting too deep")
    rows = {
        "mjd": [], "freq": [], "err": [], "obs": [], "flags": [],
        "time_offset": [],
    }
    state = state or _ParseState()
    if hasattr(path, "read"):  # file-like (timedit buffers); INCLUDE
        # inside an anonymous buffer raises in _parse_line (no base
        # directory to resolve against)
        f = path
        path = Path("<buffer>")
        for lineno, raw in enumerate(f, 1):
            _parse_line(raw, state, rows, path, lineno, include_depth)
            if state.ended:
                break
        return rows
    path = Path(path)
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            _parse_line(raw, state, rows, path, lineno, include_depth)
            if state.ended:
                break
    return rows


def build_toas_from_rows(rows) -> TOAs:
    t = TimeArray.from_mjd_strings(rows["mjd"], scale="utc")
    # Apply TIME-command offsets to the arrival times now (design note:
    # the reference defers them to the clock-correction stage via a 'to'
    # flag; baking them in at parse time is equivalent — the shifted time
    # IS the arrival time — and keeps ingest stateless).  Offsets travel
    # in a dedicated row array so a user's ordinary '-to' flag cannot
    # shift times.
    offsets = np.asarray(rows["time_offset"], dtype=np.float64)
    if np.any(offsets != 0.0):
        t = t.add_seconds(offsets)
    toas = TOAs(
        t,
        np.array(rows["freq"], dtype=np.float64),
        np.array(rows["err"], dtype=np.float64),
        rows["obs"],
        rows["flags"],
    )
    return toas


def _parse_line(raw, state, rows, path, lineno, depth):
    line = raw.strip()
    if not line:
        return
    if line.startswith(("#", "C ", "c ", "%")):
        return
    tokens = line.split()
    head = tokens[0].upper()

    if head in _COMMANDS:
        _apply_command(head, tokens, state, rows, path, depth)
        return
    if state.skip:
        return
    if state.fmt == "Tempo2":
        _parse_tempo2_toa(tokens, state, rows, path, lineno)
    else:
        _parse_princeton_toa(raw.rstrip("\n"), tokens, state, rows, path, lineno)


def _apply_command(head, tokens, state, rows, path, depth):
    if head == "FORMAT":
        state.fmt = "Tempo2" if tokens[1] == "1" else "Princeton"
    elif head == "MODE":
        pass  # fit-mode hint, ignored (reference logs and ignores too)
    elif head == "INCLUDE":
        if str(path) == "<buffer>":
            raise PintTpuError(
                "INCLUDE inside an anonymous tim buffer has no base "
                "directory to resolve against"
            )
        inc = Path(path).parent / tokens[1]
        sub = read_tim_file(inc, depth + 1, state=state)
        for k in rows:
            rows[k].extend(sub[k])
    elif head == "TIME":
        state.time_offset_s += float(tokens[1])
    elif head == "EFAC":
        state.efac = float(tokens[1])
    elif head == "EQUAD":
        state.equad_us = float(tokens[1])
    elif head == "EMIN":
        state.emin_us = float(tokens[1])
    elif head == "EMAX":
        state.emax_us = float(tokens[1])
    elif head == "FMIN":
        state.fmin_mhz = float(tokens[1])
    elif head == "FMAX":
        state.fmax_mhz = float(tokens[1])
    elif head in ("SIGMA", "TRACK", "INFO"):
        import warnings

        warnings.warn(f"tim command {head} not supported; ignored")
    elif head == "PHASE":
        state.phase += float(tokens[1])
    elif head == "SKIP":
        state.skip = True
    elif head == "NOSKIP":
        state.skip = False
    elif head == "END":
        state.ended = True
    elif head == "JUMP":
        # toggle; tag subsequent TOAs with -tim_jump N (reference: JUMP
        # blocks become maskParameter selections via flags)
        if state.in_jump:
            state.in_jump = False
        else:
            state.jump_counter += 1
            state.in_jump = True


def _common_flags(state, extra):
    flags = dict(extra)
    if state.in_jump:
        flags["tim_jump"] = str(state.jump_counter)
    if state.phase != 0.0:
        flags["padd"] = repr(state.phase)
    return flags


def _apply_err_model(err_us, state):
    return state.efac * np.hypot(err_us, state.equad_us)


def _parse_tempo2_toa(tokens, state, rows, path, lineno):
    # name freq sat err site [-flag value ...]
    if len(tokens) < 5:
        raise PintTpuError(f"{path}:{lineno}: bad Tempo2 TOA line")
    name, freq, sat, err, site = tokens[:5]
    flags = {}
    rest = tokens[5:]
    i = 0
    while i < len(rest):
        if not _is_flag_key(rest[i]):
            raise PintTpuError(
                f"{path}:{lineno}: expected -flag, got {rest[i]!r}"
            )
        key = rest[i][1:]
        # next token is this flag's value unless it is itself a flag key
        # (valueless/boolean flags; note values like '-1' are NOT keys)
        if i + 1 < len(rest) and not _is_flag_key(rest[i + 1]):
            flags[key] = rest[i + 1]
            i += 2
        else:
            flags[key] = ""
            i += 1
    flags.setdefault("name", name)
    _append_toa(rows, sat, freq, err, site, flags, state)


def _parse_princeton_toa(raw, tokens, state, rows, path, lineno):
    # Site code is column 0; remaining fields whitespace-separated:
    # name... freq mjd err [dm-correction]
    site = raw[0]
    if site.isspace():
        raise PintTpuError(
            f"{path}:{lineno}: bad Princeton TOA line (no site code)"
        )
    # find numeric fields from the right: err, mjd, freq
    if len(tokens) < 3:
        raise PintTpuError(f"{path}:{lineno}: bad Princeton TOA line")
    # tokens[0] starts with the site char; strip it
    toks = list(tokens)
    toks[0] = toks[0][1:]
    if toks[0] == "":
        toks = toks[1:]
    numeric = []
    for j, t in enumerate(toks):
        try:
            float(t)
            numeric.append(j)
        except ValueError:
            pass
    # Heuristic: the last three (or four, with DM corr) numeric tokens are
    # freq, mjd, err(, ddm).  MJD is the token containing '.', > 20000.
    mjd_idx = None
    for j in numeric:
        try:
            v = float(toks[j])
        except ValueError:
            continue
        if 20000 < v < 1000000 and "." in toks[j]:
            mjd_idx = j
    if mjd_idx is None or mjd_idx == 0 or mjd_idx + 1 >= len(toks):
        raise PintTpuError(f"{path}:{lineno}: cannot locate MJD field")
    freq = toks[mjd_idx - 1]
    sat = toks[mjd_idx]
    err = toks[mjd_idx + 1]
    flags = {}
    if toks[:mjd_idx - 1]:
        flags["name"] = toks[0]
    _append_toa(rows, sat, freq, err, site, flags, state)


def _append_toa(rows, sat, freq, err, site, flags, state):
    err_us = _apply_err_model(float(err), state)
    freq_mhz = float(freq) if float(freq) != 0.0 else np.inf
    # EMIN/EMAX/FMIN/FMAX selection commands (tempo semantics: exclude
    # TOAs outside the accepted ranges)
    if state.emin_us is not None and err_us < state.emin_us:
        return
    if state.emax_us is not None and err_us > state.emax_us:
        return
    if state.fmin_mhz is not None and freq_mhz < state.fmin_mhz:
        return
    if state.fmax_mhz is not None and freq_mhz > state.fmax_mhz:
        return
    rows["mjd"].append(sat)
    rows["freq"].append(freq_mhz)
    rows["err"].append(err_us)
    rows["obs"].append(site)
    rows["flags"].append(_common_flags(state, flags))
    rows["time_offset"].append(state.time_offset_s)


def get_TOAs_from_tim(path) -> TOAs:
    """Parse a tim file into a TOAs container (no ingest computations).
    The per-line loop is the one ingest stage that cannot chunk across
    workers: tim commands are stateful in row order (EFAC/TIME/SKIP
    carry into later rows, INCLUDE splices files)."""
    return build_toas_from_rows(read_tim_file(path))


def write_tim_file(path, toas: TOAs, name: str = "pint_tpu"):
    """Write Tempo2-format tim file (reference: TOAs.write_TOA_file);
    ``path`` may be a path or a writable file object (timedit)."""
    from pint_tpu_torch.utils.misc import open_or_use

    with open_or_use(path, "w") as f:
        f.write("FORMAT 1\n")
        mjds = toas.t.to_mjd_strings(ndigits=16)
        for i in range(len(toas)):
            flags = dict(toas.flags[i])
            nm = flags.pop("name", name)
            freq = toas.freq[i]
            freq_s = "0.000000" if not np.isfinite(freq) else f"{freq:.6f}"
            line = (
                f"{nm} {freq_s} {mjds[i]} "
                f"{toas.error_us[i]:.3f} {toas.obs[i]}"
            )
            for k, v in flags.items():
                line += f" -{k} {v}" if v != "" else f" -{k}"
            f.write(line + "\n")
