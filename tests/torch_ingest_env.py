"""Environment context of the port's ingest tests.

The counterpart of ``tests/ingest_env.py::golden_ingest_env`` for
``pint_tpu_torch``: it points the ``$PINT_TPU_*`` search paths at the
committed clock files, EOP table, SPK kernel and orbit table (the same
variables, so one environment serves both packages) and resets every
cache of the port that memoizes them (observatory registry and clock
files, EOP table, ephemeris kernels), restoring everything on exit.
Nothing of the JAX package is imported here.
"""

from __future__ import annotations

import os
import sys
from contextlib import contextmanager
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

from ingest_env import _ENV as GOLDEN_ENV  # noqa: E402
from ingest_env import DATADIR, INGEST_STEMS  # noqa: E402,F401

#: every golden set, in order
ALL_STEMS = [f"golden{i}" for i in range(1, 24)]


def reset_port_caches():
    from pint_tpu_torch.earth.eop import reset_eop
    from pint_tpu_torch.ephemeris import reset_ephemeris_cache
    from pint_tpu_torch.observatory import reset_registry

    reset_registry()
    reset_eop()
    reset_ephemeris_cache()


@contextmanager
def port_ingest_env(env: dict = GOLDEN_ENV):
    """Set ``env``, reset the port's caches; restore both on exit."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    reset_port_caches()
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        reset_port_caches()


def golden_env(stem: str):
    """The environment a golden is read in, as the reference's
    regression reads it: the committed ingest data for INGEST_STEMS,
    the bare defaults (every variable empty, read as unset) for the
    others."""
    if stem in INGEST_STEMS:
        return port_ingest_env()
    return port_ingest_env({k: "" for k in GOLDEN_ENV})


def port_golden(stem: str, **kw):
    """(model, TOAs) of a golden set, ingested by the port alone in its
    environment (warnings of the clock-less sets silenced)."""
    import warnings

    from pint_tpu_torch.models.builder import get_model_and_toas

    with warnings.catch_warnings(), golden_env(stem):
        warnings.simplefilter("ignore")
        return get_model_and_toas(str(DATADIR / f"{stem}.par"),
                                  str(DATADIR / f"{stem}.tim"), **kw)

