"""Solar-system ephemerides: SPK kernels + analytic builtin.

Counterpart of ``pint_tpu/ephemeris/`` (PINT's
solar_system_ephemerides.py is backed by jplephem and astropy's download
cache): a native SPK reader with an explicit search path
($PINT_TPU_EPHEM_DIR, then CWD) and an offline analytic fallback.
"""

from __future__ import annotations

import os
import warnings

from pint_tpu_torch.ephemeris.builtin import BuiltinEphemeris
from pint_tpu_torch.ephemeris.spk import SPK, jd_to_et, mjd_tdb_to_et  # noqa: F401

_cache: dict = {}


def reset_ephemeris_cache():
    """Forget resolved kernels (tests; $PINT_TPU_EPHEM_DIR changes —
    a cached warned-fallback BuiltinEphemeris would otherwise shadow a
    kernel that becomes findable, and vice versa)."""
    _cache.clear()


def get_ephemeris(name: str = "builtin"):
    """Resolve an ephemeris by name ('builtin', 'de440', ...) or path.

    DExxx names search $PINT_TPU_EPHEM_DIR then the CWD for
    '<name>.bsp'; a missing kernel falls back to the builtin analytic
    ephemeris with a warning (documented accuracy in builtin.py).
    """
    key = str(name).lower()
    if key in _cache:
        return _cache[key]
    if key in ("builtin", "", "none"):
        eph = BuiltinEphemeris()
    elif os.path.exists(str(name)):
        eph = SPK.open(str(name))
    else:
        candidates = []
        envdir = os.environ.get("PINT_TPU_EPHEM_DIR")
        if envdir:
            candidates.append(os.path.join(envdir, f"{key}.bsp"))
        candidates.append(f"{key}.bsp")
        for c in candidates:
            if os.path.exists(c):
                eph = SPK.open(c)
                break
        else:
            warnings.warn(
                f"ephemeris kernel {name!r} not found (searched "
                f"{candidates}); using the builtin analytic ephemeris "
                "(~10 arcsec planetary accuracy - fine for simulation, "
                "not for absolute timing parity)"
            )
            eph = BuiltinEphemeris()
    _cache[key] = eph
    return eph
