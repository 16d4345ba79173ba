"""The fuzz-oracle gate of the PyTorch port: shared harness.

``tests/test_oracle_fuzz.py`` draws random compositions (astrometry
flavour x binary model x dispersion/chromatic set x noise x jumps,
glitches, waves, piecewise spindown) inside a random full-ingest
environment (``tests/fuzz_ingest.py``: clock chains with gaps, nonzero
EOP, freshly written SPK kernels, multi-site and satellite
observatories), ingests them through the JAX package and holds them to
the mpmath oracle, whose outputs for the past rounds' seeds are
committed under ``tests/datafile/oracle_cache/fuzz_*``.

The port's fuzz tests (``tests/test_torch_fuzz_{res,fit,wb}.py``) build
the same cases: the draw imports the JAX package, so it runs in ONE
patched reference subprocess per test file
(``torch_reference.run_reference``), with the reference test's own draw
functions and rng streams, and exports each case's ingested state
(``export_state``) and the oracle arrays it finds through
``oracle/cache.py::cached_oracle``.  The ``compute`` given to the cache
raises, so no mpmath runs live and nothing is written under
``tests/datafile/``: a miss means the draw drifted from the committed
cache, and that case fails saying so.  The last seed of
``FUZZ_SEEDS`` has no cache (the reference recomputes it live) and is
left out.
"""

from __future__ import annotations

import textwrap

import numpy as np
import pytest

#: FUZZ_SEEDS[:-1] and the per-round case counts of
#: tests/test_oracle_fuzz.py (read there by the reference script, which
#: checks that these agree)
SEEDS = [2604, 3107, 4181, 5923, 6841, 7459, 8317, 9203]
CASES = {"res": 5, "fit": 2, "wb": 1}

#: the reference test's fit-parity tolerances (test_oracle_fuzz._FIT_TOL)
FIT_TOL = dict(value_tol_sigma=3e-3, sigma_rtol=3e-5, chi2_rtol=1e-5)

_SCRIPT = """
import traceback
from pathlib import Path

import test_oracle_fuzz as tf
from fuzz_ingest import env_parts
from oracle.cache import cached_oracle

assert tf.FUZZ_SEEDS[:-1] == {seeds!r}, tf.FUZZ_SEEDS
assert (tf.CASES_PER_ROUND, tf.FIT_CASES_PER_ROUND,
        tf.WB_CASES_PER_ROUND) == {counts!r}
assert tf._FIT_TOL == {fit_tol!r}
KIND = {kind!r}
ROOT = Path(os.environ["FUZZ_TMP"])


def no_live_oracle(name):
    def compute():
        raise RuntimeError(
            f"no committed oracle cache matches {{name}}: the draw drifted "
            "from tests/datafile/oracle_cache (the port's tests never run "
            "the mpmath oracle)")
    return compute


def draw(seed, case, tmp):
    # test_oracle_fuzz's own rng streams and draw, per kind
    if KIND == "res":
        rng = np.random.default_rng([seed, case])
        ing = tf._draw_env(np.random.default_rng([seed, 5000 + case]), tmp)
        return tf._compose_pulsar(rng, tmp, sim_seed=seed * 100 + case,
                                  ingest=ing)
    if KIND == "fit":
        rng = np.random.default_rng([seed, 1000 + case])
        ing = tf._draw_env(np.random.default_rng([seed, 6000 + case]), tmp)
        return tf._compose_pulsar(
            rng, tmp, sim_seed=seed * 100 + 50 + case, stem="fuzzfit",
            mark_fit=True, ingest=ing)
    rng = np.random.default_rng([seed, 2000 + case])
    ing = tf._draw_env(np.random.default_rng([seed, 7000 + case]), tmp)
    ing["want_tcb"] = False
    extra = [f"DMJUMP -f L-wide {{rng.normal(0, 2e-3):.4e}} 1"]
    if rng.random() < 0.5:
        extra.append(f"DMEFAC -f S-wide {{rng.uniform(0.8, 1.4):.3f}}")
    if rng.random() < 0.5:
        extra.append(f"DMEQUAD -f L-wide {{rng.uniform(1e-5, 2e-4):.3e}}")
    return tf._compose_pulsar(
        rng, tmp, sim_seed=seed * 100 + 70 + case, stem="fuzzwb",
        strip=("NE_SW",), mark_fit=True, extra_lines=extra,
        wideband=True, ingest=ing)


for seed in {seeds!r}:
    for case in range({ncases}):
        key = f"{{KIND}}/{{seed}}/{{case}}"
        try:
            tmp = ROOT / f"{{seed}}_{{case}}"
            tmp.mkdir(parents=True)
            par, tim, par_text, model, toas = draw(seed, case, tmp)
            cm = model.compile(toas)
            free = list(cm.free_names)
            parts = [Path(par).read_bytes(), Path(tim).read_bytes(),
                     *env_parts(tmp / "env")]
            if KIND != "res":
                parts += [",".join(free), "niter=2"]
            name = f"fuzz_{{KIND}}_{{seed}}_{{case}}"
            got = cached_oracle(name, parts, no_live_oracle(name))
            for k, v in got.items():
                OUT[f"{{key}}/oracle/{{k}}"] = v
            export_state(cm, key)
            OUT[f"{{key}}/par"] = np.array(par_text)
        except Exception:
            OUT[f"{{key}}/error"] = np.array(traceback.format_exc())
"""


def reference_script(kind: str) -> str:
    """The reference script that draws every cached case of ``kind``
    ('res', 'fit' or 'wb') under ``$FUZZ_TMP`` and exports, per case
    ``<kind>/<seed>/<case>``: its state, its oracle arrays under
    ``/oracle/``, its par text, or ``/error`` with the traceback of
    whatever failed."""
    return textwrap.dedent(_SCRIPT).format(
        seeds=SEEDS, counts=(CASES["res"], CASES["fit"], CASES["wb"]),
        fit_tol=FIT_TOL, kind=kind, ncases=CASES[kind])


def cases(kind: str) -> list[tuple[int, int]]:
    return [(s, c) for s in SEEDS for c in range(CASES[kind])]


def case_key(kind: str, seed: int, case: int, ref: dict) -> str:
    """The case's prefix in the reference's output; a case the reference
    could not build (or whose oracle is not cached) fails here."""
    key = f"{kind}/{seed}/{case}"
    if f"{key}/error" in ref:
        raise AssertionError(
            f"reference could not build fuzz case {key}:\n"
            f"{ref[key + '/error']}")
    return key


# the angle parameters' par-file uncertainty units per radian (tempo
# convention: seconds of time for H:M:S, arcseconds for D:M:S)
_UNC_PER_RAD = {"H:M:S": 12.0 * 3600.0 / np.pi,
                "D:M:S": 180.0 * 3600.0 / np.pi, "deg": 180.0 / np.pi}


def value_sigma(p) -> tuple[float, float]:
    """A fitted port parameter's (value, sigma) in the oracle's units:
    test_oracle_fit._fw_value_sigma for the port's parameters (angles in
    radians, their sigma the internal radian uncertainty)."""
    v = p.value
    v = float(v.to_float()) if hasattr(v, "to_float") else float(v)
    if type(p).__name__ == "AngleParameter":
        return v, float(p.uncertainty) / _UNC_PER_RAD.get(p.units, 1.0)
    return v, float(p.uncertainty)


def assert_fit_parity(f, chi2_fw, values, sigmas, chi2_or,
                      value_tol_sigma, sigma_rtol, chi2_rtol, label=""):
    """test_oracle_fit._assert_fit_parity over a port fitter, check for
    check (``pytest.approx`` as there): every free value within
    ``value_tol_sigma`` of the oracle's sigma, every sigma within
    ``sigma_rtol`` and chi2 within ``chi2_rtol`` relative."""
    for name in f.cm.free_names:
        v_fw, s_fw = value_sigma(f.model.params[name])
        v_or, s_or = float(values[name]), float(sigmas[name])
        assert abs(v_fw - v_or) < value_tol_sigma * s_or, (
            f"{label} {name}: port {v_fw!r} vs oracle {v_or!r} "
            f"({abs(v_fw - v_or) / s_or:.2e} sigma)")
        assert s_fw == pytest.approx(s_or, rel=sigma_rtol), (
            f"{label} {name}: sigma {s_fw!r} vs oracle {s_or!r}")
    assert chi2_fw == pytest.approx(chi2_or, rel=chi2_rtol), (
        f"{label} chi2 {chi2_fw!r} vs oracle {chi2_or!r}")
