"""Parity of the port's own host ingest with the JAX package.

Every golden set is read by ``pint_tpu_torch.models.builder.
get_model_and_toas`` alone (tim parsing, the clock chain, TDB, Earth
rotation, the ephemeris, the observatories, golden21's ``testsat``
satellite and golden22's topocentric TZR row included) in the
environment the reference's regression reads it in
(``tests/torch_ingest_env.py``).  The reference ingests the same files
in one subprocess (``tests/torch_reference.py``) and exports its
columns.  Tolerances: every ingested column bitwise equal to the
reference's; residuals within 1 ns of each golden's oracle.

Also here: one chunked ingest at 20,000 TOAs bitwise equal to the
reference's, a ``JUMP tel`` mask and its residuals, the ingest cache's
separation from the reference's, and ROADMAP A11's gate: a subprocess in
which ``import jax`` and ``import pint_tpu`` raise ingests every golden
and fits ``tests/test_torch_fit_layer.py::FIT_CASES`` on the CPU at
``test_golden_fits``'s criteria against the oracles.
"""

import json
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from torch_ingest_env import (  # noqa: E402
    ALL_STEMS,
    DATADIR,
    GOLDEN_ENV,
    port_golden,
    port_ingest_env,
)
from torch_reference import BENCH_PAR, REPO, run_reference  # noqa: E402

#: the 20,000-TOA chunked-ingest case: bench.py's pulsar with the
#: committed ephemeris (Earth and Sun only: golden6 covers the planets),
#: four sites cycling
PAR_BIG = BENCH_PAR + "EPHEM mini_vsop87\nCLOCK TT(BIPM2021)\n"
NBIG = 20000
#: golden14 (gbt and jodrell) with a JUMP on one telescope
PAR_TEL = (DATADIR / "golden14.par").read_text() + "JUMP tel jodrell 2e-6 1\n"

REF_SCRIPT = r"""
import contextlib, warnings
from ingest_env import INGEST_STEMS, golden_ingest_env
from pint_tpu.io.tim import get_TOAs_from_tim
from pint_tpu.models.builder import get_model, get_model_and_toas
from pint_tpu.toas import cache as tcache
from pint_tpu.toas.ingest import ingest_for_model

def cols(prefix, t):
    OUT[prefix + "/t_day"] = t.t.mjd_int
    OUT[prefix + "/t_hi"] = t.t.sec.hi
    OUT[prefix + "/t_lo"] = t.t.sec.lo
    OUT[prefix + "/tdb_day"] = t.t_tdb.mjd_int
    OUT[prefix + "/tdb_hi"] = t.t_tdb.sec.hi
    OUT[prefix + "/tdb_lo"] = t.t_tdb.sec.lo
    OUT[prefix + "/freq"] = t.freq
    OUT[prefix + "/error_us"] = t.error_us
    for c in ("clock_corr_s", "ssb_obs_pos", "ssb_obs_vel", "obs_sun_pos",
              "obs_lat_rad", "obs_alt_m", "obs_elevation_rad"):
        v = getattr(t, c)
        if v is not None:
            OUT[prefix + "/" + c] = v
    for b, v in t.obs_planet_pos.items():
        OUT[prefix + "/planet:" + b] = v
    OUT[prefix + "/obs"] = np.array(json.dumps(list(t.obs)))
    OUT[prefix + "/flags"] = np.array(json.dumps(list(t.flags)))

for i in range(1, 24):
    stem = f"golden{i}"
    env = (golden_ingest_env() if stem in INGEST_STEMS
           else contextlib.nullcontext())
    with warnings.catch_warnings(), env:
        warnings.simplefilter("ignore")
        m, t = get_model_and_toas(f"tests/datafile/{stem}.par",
                                  f"tests/datafile/{stem}.tim")
        absph = m.components.get("AbsPhase")
        if absph is not None and absph.params["TZRMJD"].value is not None:
            cols(stem + "/tzr", absph.ingested_tzr_toas(m))
    cols(stem, t)

os.environ["PINT_TPU_INGEST_WORKERS"] = "4"
with warnings.catch_warnings(), golden_ingest_env():
    warnings.simplefilter("ignore")
    m = get_model(os.environ["PAR_BIG"])
    t = ingest_for_model(get_TOAs_from_tim(os.environ["TIM_BIG"]), m)
cols("big", t)

with warnings.catch_warnings(), golden_ingest_env():
    warnings.simplefilter("ignore")
    m, t = get_model_and_toas(os.environ["PAR_TEL"],
                              "tests/datafile/golden14.tim")
    cm = m.compile(t)
name = next(n for n, q in m.params.items()
            if getattr(q, "key", None) == "tel")
OUT["tel/mask"] = np.asarray(cm.bundle.masks[name])
OUT["tel/resid"] = np.asarray(cm.time_residuals(cm.x0()))

# the reference's ingest cache of golden14, and its options key
os.environ["PINT_TPU_CACHE_DIR"] = os.environ["CACHE_DIR"]
with warnings.catch_warnings(), golden_ingest_env():
    warnings.simplefilter("ignore")
    m = get_model("tests/datafile/golden14.par")
    tcache.get_TOAs("tests/datafile/golden14.tim", model=m, usepickle=True)
OUT["cache/key"] = np.array(tcache._options_key(model_par="PSR X\n"))
"""


def _big_tim(path):
    """A 20,000-TOA tim file over MJD 54500-55900 at four sites."""
    from pint_tpu_torch.io.tim import write_tim_file
    from pint_tpu_torch.timebase.times import TimeArray
    from pint_tpu_torch.toas.toas import TOAs

    sites = ("gbt", "effelsberg", "jodrell", "parkes")
    t = TimeArray.from_mjd_float(np.linspace(54500.0, 55900.0, NBIG),
                                 scale="utc")
    toas = TOAs(t, np.resize([820.0, 1400.0, 2300.0], NBIG),
                np.full(NBIG, 1.0), [sites[i % 4] for i in range(NBIG)],
                [{"f": ("L-wide", "S-wide")[i % 2]} for i in range(NBIG)])
    write_tim_file(str(path), toas)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("ingest")
    _big_tim(d / "big.tim")
    (d / "cache").mkdir()
    return d


@pytest.fixture(scope="module")
def ref(work):
    return run_reference(REF_SCRIPT, work / "ref.npz", env={
        "PAR_BIG": PAR_BIG, "TIM_BIG": str(work / "big.tim"),
        "PAR_TEL": PAR_TEL, "CACHE_DIR": str(work / "cache")},
        timeout=600)


@pytest.fixture(scope="module")
def goldens():
    """stem -> (model, TOAs), ingested by the port."""
    return {stem: port_golden(stem) for stem in ALL_STEMS}


def _assert_columns(ref, prefix, t):
    """Every column of the port's TOAs bitwise equal to the
    reference's."""
    got = {
        "t_day": t.t.mjd_int, "t_hi": t.t.sec.hi, "t_lo": t.t.sec.lo,
        "tdb_day": t.t_tdb.mjd_int, "tdb_hi": t.t_tdb.sec.hi,
        "tdb_lo": t.t_tdb.sec.lo, "freq": t.freq, "error_us": t.error_us,
    }
    for c in ("clock_corr_s", "ssb_obs_pos", "ssb_obs_vel", "obs_sun_pos",
              "obs_lat_rad", "obs_alt_m", "obs_elevation_rad"):
        if getattr(t, c) is not None:
            got[c] = getattr(t, c)
    for b, v in t.obs_planet_pos.items():
        got["planet:" + b] = v
    want = {k[len(prefix) + 1:]: v for k, v in ref.items()
            if k.startswith(prefix + "/") and "/" not in k[len(prefix) + 1:]}
    assert json.loads(str(want.pop("obs"))) == list(t.obs)
    assert json.loads(str(want.pop("flags"))) == list(t.flags)
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=f"{prefix}:{k}")


@pytest.mark.parametrize("stem", ALL_STEMS)
def test_golden_columns_bitwise(ref, goldens, stem):
    """The port's ingested columns of each golden (times, TDB, clock
    corrections, geometry, planets, troposphere, sites and flags) equal
    the reference's bit for bit."""
    _assert_columns(ref, stem, goldens[stem][1])


@pytest.mark.parametrize("stem", ALL_STEMS)
def test_golden_residuals_match_oracle(goldens, stem):
    """The port's residuals of its own ingest: within 1 ns of the
    oracle, the golden regression bar."""
    model, toas = goldens[stem]
    cm = model.compile(toas, device="cpu")
    r = cm.time_residuals(cm.x0()).numpy()
    oracle = np.load(DATADIR / f"{stem}_oracle.npz")
    np.testing.assert_allclose(r, oracle["resid"], rtol=0, atol=1e-9)


def test_topocentric_tzr_row(ref, goldens):
    """golden22's TZR arrival (TZRSITE gbt) ingested by the port when the
    model was built, in the committed environment: its columns are the
    reference's bit for bit, and it is the row the compiled model
    anchors on."""
    model, toas = goldens["golden22"]
    absph = model.components["AbsPhase"]
    assert absph.params["TZRSITE"].value.lower() == "gbt"
    tzr = absph.ingested_tzr_toas(model)
    assert tzr.obs == ["gbt"] and tzr.t.scale == "utc"
    _assert_columns(ref, "golden22/tzr", tzr)
    cm = model.compile(toas, device="cpu")
    np.testing.assert_array_equal(
        cm.bundle.tzr.tdb_sec.hi.numpy(), tzr.t_tdb.sec.hi)
    np.testing.assert_array_equal(
        cm.bundle.tzr.ssb_obs_pos_ls.numpy()[0],
        tzr.ssb_obs_pos[0] / 299792458.0)


def test_chunked_ingest_20k_bitwise(ref, work, monkeypatch):
    """One chunked ingest of 20,000 TOAs at four sites (two chunks of
    the thread pool, troposphere geometry) equals the reference's bit
    for bit."""
    from pint_tpu_torch.io.tim import get_TOAs_from_tim
    from pint_tpu_torch.models.builder import get_model
    from pint_tpu_torch.toas import ingest_topo
    from pint_tpu_torch.toas.ingest import ingest_for_model

    monkeypatch.setenv("PINT_TPU_INGEST_WORKERS", "4")
    seen = []
    real = ingest_topo._run_parallel
    monkeypatch.setattr(ingest_topo, "_run_parallel",
                        lambda plan, toas, edges: seen.append(len(edges) - 1)
                        or real(plan, toas, edges))
    with warnings.catch_warnings(), port_ingest_env():
        warnings.simplefilter("ignore")
        m = get_model(PAR_BIG)
        t = ingest_for_model(get_TOAs_from_tim(str(work / "big.tim")), m)
    assert seen == [2]
    _assert_columns(ref, "big", t)


def test_jump_tel_mask(ref):
    """``JUMP tel jodrell``: the port selects the jodrell TOAs of
    golden14 (the reference's mask bit for bit) and its residuals with
    the jump are within 1e-11 s of the reference's."""
    from pint_tpu_torch.models.builder import get_model_and_toas

    with warnings.catch_warnings(), port_ingest_env():
        warnings.simplefilter("ignore")
        model, toas = get_model_and_toas(PAR_TEL,
                                         str(DATADIR / "golden14.tim"))
    name, p = next((n, q) for n, q in model.params.items()
                   if getattr(q, "key", None) == "tel")
    assert p.key_value == ["jodrell"] and not p.frozen
    cm = model.compile(toas, device="cpu")
    mask = cm.bundle.masks[name].numpy()
    np.testing.assert_array_equal(mask, ref["tel/mask"])
    np.testing.assert_array_equal(
        mask, np.array([o == "jodrell" for o in toas.obs], float))
    assert 0 < mask.sum() < len(mask)
    r = cm.time_residuals(cm.x0()).numpy()
    np.testing.assert_allclose(r, ref["tel/resid"], rtol=0, atol=1e-11)


def test_cache_never_loads_reference_file(ref, work, monkeypatch):
    """The reference's ingest cache (written in its subprocess) is never
    loaded by the port: another file name, and a key the port never
    writes; the port's ingest of the same tim runs and writes its own
    file."""
    import shutil

    from pint_tpu_torch.models.builder import get_model
    from pint_tpu_torch.toas import cache as tcache
    from pint_tpu_torch.toas import ingest as ingest_mod

    cdir = work / "cache"
    ref_file = cdir / "golden14.tim.ingest.npz"
    assert ref_file.exists()
    assert str(ref["cache/key"]) != tcache._options_key(model_par="PSR X\n")
    monkeypatch.setenv("PINT_TPU_CACHE_DIR", str(cdir))
    calls = []
    real = ingest_mod.ingest_for_model
    monkeypatch.setattr(ingest_mod, "ingest_for_model",
                        lambda t, m, **kw: calls.append(len(t))
                        or real(t, m, **kw))
    tim = str(DATADIR / "golden14.tim")
    with warnings.catch_warnings(), port_ingest_env():
        warnings.simplefilter("ignore")
        m = get_model(str(DATADIR / "golden14.par"))
        t = tcache.get_TOAs(tim, model=m, usepickle=True)
        assert calls == [len(t)]  # ingested, nothing loaded
        assert (cdir / "golden14.tim.torch-ingest.npz").exists()
        # the reference's file under the port's name: its key is refused
        shutil.copy(ref_file, cdir / "golden14.tim.torch-ingest.npz")
        opts = {"model_par": m.as_parfile()}
        assert tcache.load_cache(tim, **opts) is None
        assert tcache._load_npz(tim, **opts) is None


GATE_SCRIPT = r"""
import importlib.abc, json, sys, warnings

class Bar(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax.") or name == "pint_tpu" \
                or name.startswith("pint_tpu."):
            raise ImportError(f"{name} is barred")
        return None

sys.meta_path.insert(0, Bar())
sys.path.insert(0, REPO)
sys.path.insert(0, REPO + "/tests")
import numpy as np
from torch_ingest_env import ALL_STEMS, DATADIR, port_golden
import pint_tpu_torch.fitting as fitting

gaps = {}
for stem in ALL_STEMS:
    model, toas = port_golden(stem)
    cm = model.compile(toas, device="cpu")
    r = cm.time_residuals(cm.x0()).numpy()
    gaps[stem] = float(np.max(np.abs(
        r - np.load(DATADIR / f"{stem}_oracle.npz")["resid"])))
fits = []
for cls, stem in CASES:
    model, toas = port_golden(stem)
    f = getattr(fitting, cls)(toas, model, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = f.fit_toas()
    o = np.load(DATADIR / f"{stem}_oracle.npz")
    vals = []
    for name, val, unc in zip(o["names"], o["values"], o["uncs"]):
        p = model.params[str(name)]
        vals.append([str(name), abs(float(p.value) - val) / unc,
                     p.uncertainty / unc - 1.0])
    fits.append([cls, stem, chi2 / float(o["chi2"]) - 1.0, vals])
barred = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "pint_tpu"))
print(json.dumps({"gaps": gaps, "fits": fits, "barred": barred}))
"""


def test_gate_without_jax_or_reference():
    """ROADMAP A11's gate on the CPU: with ``import jax`` and ``import
    pint_tpu`` raising, the port ingests all 23 goldens within 1 ns of
    their oracles and fits FIT_CASES at test_golden_fits's criteria
    (chi2 1e-6 relative, values within 1e-3 sigma, uncertainties 1e-6
    relative)."""
    from test_torch_fit_layer import FIT_CASES

    code = (f"REPO = {str(REPO)!r}\nCASES = {FIT_CASES!r}\n"
            + textwrap.dedent(GATE_SCRIPT))
    env = {k: v for k, v in os.environ.items() if k not in GOLDEN_ENV}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=str(REPO), env=env)
    assert proc.returncode == 0, proc.stderr[-6000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["barred"] == []
    assert sorted(out["gaps"]) == sorted(ALL_STEMS)
    for stem, gap in out["gaps"].items():
        assert gap < 1e-9, (stem, gap)
    assert len(out["fits"]) == len(FIT_CASES)
    for cls, stem, chi2_rel, vals in out["fits"]:
        assert abs(chi2_rel) < 1e-6, (cls, stem, chi2_rel)
        for name, dv, dunc in vals:
            assert dv < 1e-3, (cls, stem, name, dv)
            assert abs(dunc) < 1e-6, (cls, stem, name, dunc)
