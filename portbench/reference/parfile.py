"""A small par-file reader for the plain reference.

It reads the lines the benchmark's configurations write: ``NAME VALUE
[FIT]``, the mask families ``NAME -f FLAGVALUE VALUE [FIT]`` (JUMP, EFAC,
EQUAD, ECORR), the DMX ranges and ``PSR`` and ``BINARY``.  Every number
is kept as the exact rational of its decimal text, so a parameter given
to more digits than a float64 holds (F0, PB, the epochs) loses nothing
before the model converts it to its internal units.  A mask parameter is
named by its family and its position among the family's lines (JUMP1,
EFAC2, ...), as the port names them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction

MASK_FAMILIES = ("JUMP", "EFAC", "EQUAD", "ECORR")


@dataclass
class Par:
    """Parsed par text: ``values`` maps a name to its exact value,
    ``masks`` a mask parameter's name to its (flag key, flag value),
    ``free`` lists the names with a fit flag of 1 in file order."""

    values: dict = field(default_factory=dict)
    masks: dict = field(default_factory=dict)
    free: list = field(default_factory=list)
    strings: dict = field(default_factory=dict)


def parse_number(text: str) -> Fraction:
    return Fraction(text.replace("D", "e").replace("d", "e"))


def read_par(text: str) -> Par:
    par = Par()
    counts = {f: 0 for f in MASK_FAMILIES}
    for line in text.splitlines():
        tok = line.split()
        if not tok or tok[0].startswith("#"):
            continue
        name = tok[0]
        if name in ("PSR", "BINARY", "ECL", "UNITS"):
            par.strings[name] = tok[1]
            continue
        if name in MASK_FAMILIES:
            counts[name] += 1
            key = f"{name}{counts[name]}"
            if not tok[1].startswith("-"):
                raise ValueError(f"mask parameter without a flag: {line!r}")
            par.masks[key] = (tok[1][1:], tok[2])
            par.values[key] = parse_number(tok[3])
            if len(tok) > 4 and tok[4] == "1":
                par.free.append(key)
            continue
        par.values[name] = parse_number(tok[1])
        if len(tok) > 2 and tok[2] == "1":
            par.free.append(name)
    return par
