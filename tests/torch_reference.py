"""Reference harness for the PyTorch port's parity tests.

The JAX package runs in a SUBPROCESS, never in the pytest process: under
jax 0.9 ``import pint_tpu.ops`` fails at ``pint_tpu/ops/dd.py:58``
(``primitive_batchers`` lost ``__contains__``), and the one-line patch
that restores it must not leak into any other test's process.  The
subprocess applies the patch before its first ``pint_tpu`` import, runs
on the CPU in x64, executes a test file's reference script, and saves
every array it produced into an ``.npz`` that the test then reads.

Reference scripts fill a dict ``OUT`` (name -> array or JSON-able value)
and may call ``export_state(cm, prefix)`` to carry a CompiledModel's
inputs across in the format of ``pint_tpu_torch.convert``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
TESTS = REPO / "tests"

BENCH_PAR = """
PSR              J1744-1134
F0               245.4261196898081  1
F1               -5.38e-16          1
PEPOCH           55000
DM               3.1380             1
RAJ              17:44:29.403209    1
DECJ             -11:34:54.68067    1
EFAC             -f L-wide 1.1
EQUAD            -f L-wide 0.5
TNREDAMP         -13.5
TNREDGAM         3.7
TNREDC           30
"""

#: (n, k) shapes of the fused-Gram parity cases (p1 = 7)
GRAM_CASES = [(1000, 1), (1000, 60), (8193, 1), (8193, 60)]


def gram_inputs(n, k, p1=7, seed=0):
    """Basis T (n, k), |max|-prescaled wide-range design A (n, p1) and
    weights w (n,) for the joint-Gram parity cases."""
    rng = np.random.default_rng(seed + 1000 * k + n)
    T = rng.standard_normal((n, k))
    M = rng.standard_normal((n, p1)) * np.logspace(0, 10, p1)
    A = M / np.max(np.abs(M), axis=0)
    w = rng.uniform(0.5, 2.0, n)
    return T, A, w


def fourier_inputs(n, k, p, seed=5):
    """Times t (n,) over 3e8 s, harmonic frequencies (k,), weights (n,)
    and columns X (n, p) for the wide Fourier-kernel cases."""
    rng = np.random.default_rng(seed + n + k + p)
    tspan = 3.0e8
    t = np.sort(rng.uniform(0, tspan, n))
    freqs = np.arange(1, k + 1) / tspan
    w = rng.uniform(0.5, 2.0, n)
    X = rng.normal(size=(n, p))
    return t, freqs, w, X


def dd_inputs():
    """Double-double operands (a + la, b + lb) over twenty decades."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal(64) * 10.0 ** rng.integers(-8, 12, 64)
    b = rng.standard_normal(64) * 10.0 ** rng.integers(-8, 12, 64)
    la = a * 1e-17 * rng.standard_normal(64)
    lb = b * 1e-17 * rng.standard_normal(64)
    return a, la, b, lb


_PRELUDE = r'''
import json, os, sys
import jax
# jax 0.9: restore `p in primitive_batchers` for pint_tpu/ops/dd.py:58
type(jax.interpreters.batching.primitive_batchers).__contains__ = (
    lambda s, k: True
)
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import numpy as np

OUT = {{}}
META = {{}}


def export_state(cm, prefix):
    from pint_tpu.timebase.hostdd import HostDD
    b = cm.bundle
    cols = dict(
        tdb_day=b.tdb_day, tdb_sec_hi=b.tdb_sec.hi, tdb_sec_lo=b.tdb_sec.lo,
        freq_mhz=b.freq_mhz, error_us=b.error_us,
        ssb_obs_pos_ls=b.ssb_obs_pos_ls, ssb_obs_vel_c=b.ssb_obs_vel_c,
        obs_sun_pos_ls=b.obs_sun_pos_ls, pulse_number=b.pulse_number,
        padd=b.padd,
    )
    for k, v in cols.items():
        OUT[f"{{prefix}}/bundle/{{k}}"] = np.asarray(v)
    for k, v in b.masks.items():
        OUT[f"{{prefix}}/masks/{{k}}"] = np.asarray(v)
    for k, v in b.obs_planet_pos_ls.items():
        OUT[f"{{prefix}}/planet/{{k}}"] = np.asarray(v)
    static = {{}}
    for n, v in cm.ref.items():
        if isinstance(v, HostDD):
            OUT[f"{{prefix}}/ref/{{n}}"] = np.array([v.hi, v.lo], float)
        elif isinstance(v, tuple) and isinstance(v[1], HostDD):
            OUT[f"{{prefix}}/ref/{{n}}"] = np.array(
                [v[0], v[1].hi, v[1].lo], float)
        elif isinstance(v, (bool, str)):
            static[n] = v
        else:
            OUT[f"{{prefix}}/ref/{{n}}"] = np.array([v], float)
    comps = []
    for c in cm.model._ordered_components():
        spec = {{"name": type(c).__name__, "params": list(c.params)}}
        if c.mask_params:
            spec["masks"] = list(c.mask_params)
        comps.append(spec)
    META[prefix] = dict(static=static, components=comps,
                        free_names=list(cm.free_names))
'''

_EPILOGUE = r'''
OUT["__meta__"] = np.array(json.dumps(META))
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in OUT.items()})
'''


def run_reference(script: str, out_path, env=None, timeout=300) -> dict:
    """Run ``script`` against the JAX package in a fresh interpreter and
    return the arrays it put in ``OUT`` (plus ``"__meta__"``, parsed)."""
    code = (
        _PRELUDE.format(repo=str(REPO), tests=str(TESTS))
        + textwrap.dedent(script)
        + _EPILOGUE
    )
    full_env = dict(os.environ)
    full_env.update(env or {})
    proc = subprocess.run(
        [sys.executable, "-c", code, str(out_path)],
        env=full_env, capture_output=True, text=True, timeout=timeout,
        cwd=str(REPO),
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"reference subprocess failed ({proc.returncode}):\n"
            f"{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}"
        )
    with np.load(out_path) as z:
        out = {k: z[k] for k in z.files}
    out["__meta__"] = json.loads(str(out["__meta__"]))
    return out


def load_state(ref_out: dict, prefix: str) -> dict:
    """The ``pint_tpu_torch.convert.state_from_numpy`` dict of an
    ``export_state(cm, prefix)`` call."""
    meta = ref_out["__meta__"][prefix]
    bundle, masks, planets, ref = {}, {}, {}, dict(meta["static"])
    for key, v in ref_out.items():
        if not key.startswith(prefix + "/"):
            continue
        _, kind, name = key.split("/", 2)
        if kind == "bundle":
            bundle[name] = v
        elif kind == "masks":
            masks[name] = v
        elif kind == "planet":
            planets[name] = v
        elif kind == "ref":
            ref[name] = float(v[0]) if v.shape == (1,) else tuple(
                float(e) for e in v
            )
    bundle["masks"] = masks
    bundle["obs_planet_pos_ls"] = planets
    return {
        "bundle": bundle,
        "ref": ref,
        "free_names": meta["free_names"],
        "components": meta["components"],
    }


def bench_build_script(ntoa: int, prefix: str = "bench") -> str:
    """Reference script that builds bench.py's pulsar at ``ntoa`` TOAs
    and exports its state as ``prefix``; leaves ``model, toas, cm``."""
    return textwrap.dedent(f"""
    import bench
    model, toas, cm = bench._build({ntoa})
    export_state(cm, {prefix!r})
    """)


def golden13_script(prefix: str = "golden13") -> str:
    """Reference script that ingests golden13 through the committed
    clock/EOP/ephemeris data and exports its state as ``prefix``; leaves
    ``g_model, g_toas, g_cm``."""
    return textwrap.dedent(f"""
    import warnings
    from ingest_env import golden_ingest_env
    from pint_tpu.models.builder import get_model_and_toas
    with warnings.catch_warnings(), golden_ingest_env():
        warnings.simplefilter("ignore")
        g_model, g_toas = get_model_and_toas(
            "tests/datafile/golden13.par", "tests/datafile/golden13.tim")
    g_cm = g_model.compile(g_toas)
    export_state(g_cm, {prefix!r})
    """)
