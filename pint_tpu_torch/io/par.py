"""Par-file (pulsar ephemeris) parsing.

Counterpart of ``pint_tpu/io/par.py``: a par file is ``NAME value [fit]
[uncertainty]`` lines; repeated names are legal (JUMP families); '#' and
'C '-style comments.  Component selection from the parsed dict happens
in ``models/builder.py``.
"""

from __future__ import annotations

import io
import os
from collections import OrderedDict

__all__ = ["parse_parfile", "par_text"]


def par_text(par) -> str:
    """The reference's ``utils/misc.py::lines_of`` rule: a str holding a
    newline is par text; any other str or path is a file to read; else
    ``par`` is an open file."""
    if isinstance(par, str) and "\n" in par:
        return par
    if isinstance(par, (str, os.PathLike)):
        with open(par) as f:
            return f.read()
    return par.read()


def parse_parfile(par) -> "OrderedDict[str, list[list[str]]]":
    """Par file (path, text or open file) -> {UPPER_NAME: [token-list,
    ...]} (repeats allowed)."""
    out: OrderedDict[str, list[list[str]]] = OrderedDict()
    for raw in io.StringIO(par_text(par)):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.upper().startswith(("C ", "CC ")):
            continue
        line = line.split("#", 1)[0].strip()
        tokens = line.split()
        if tokens:
            out.setdefault(tokens[0].upper(), []).append(tokens[1:])
    return out

