"""The port's command-line tools, event TOAs and FITS output.

- Twins of every test of ``tests/test_scripts_photon.py``: zima then
  pintempo, compare_parfiles, tcb2tdb, pintbary, the FITS roundtrip with
  ``add_column``, the photon path through photonphase (pulsed events give
  a large H-test, uniform ones a small one), the logging dedup, and
  photonphase's PULSE_PHASE on golden22's TZR-anchored model against the
  independent mpmath oracle within the reference test's 1e-6 cycles.
- Twins of ``tests/test_utils_cache_plots.py``'s ``test_t2binary2pint``,
  ``test_pintpublish`` and ``test_event_optimize_recovers_f0`` (the same
  F0 gate, 3e-5).
- Against the reference on the same files: ``load_event_TOAs`` (MJD
  split, TT->UTC, weights, energies) column for column bitwise,
  photonphase's PULSE_PHASE within 1e-12 cycles, pintbary's output and
  tcb2tdb's and t2binary2pint's par text string for string.

Every tool runs as ``main(argv)`` with ``--device cpu``.  The reference
and the oracle run once for the module in a subprocess
(tests/torch_reference.py).
"""

import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from torch_ingest_env import DATADIR, port_ingest_env  # noqa: E402
from torch_reference import run_reference  # noqa: E402

from pint_tpu_torch.constants import L_B  # noqa: E402
from pint_tpu_torch.io.fits import (  # noqa: E402
    add_column,
    get_bintable,
    write_event_fits,
)
from pint_tpu_torch.models.builder import get_model  # noqa: E402

PAR = """PSR J1744-1134
F0 245.4261196898081 1
F1 -5.38e-16 1
PEPOCH 55000
DM 3.1380 1
"""
CPU = ["--device", "cpu", "--log-level", "ERROR"]
#: golden22's events: barycentric TDB seconds after MJD 55200
G22_MET = np.linspace(137.0, 85000.0, 25)
#: pintbary's input, as the reference test gives it
BARY_ARGS = ["55000.0", "55100.5", "--ra", "06:13:43.97",
             "--dec=-02:00:47.2", "--obs", "geocenter"]
T2_EXTRA = """
BINARY T2
PB 1.5
A1 3.2
TASC 55000.1
EPS1 1.2e-5
EPS2 -0.7e-5
"""


def _event_files(work: Path):
    """The files both sides read: golden22's barycentric events, and a
    TT event file at the geocentre with weights and energies."""
    write_event_fits(
        str(work / "g22_events.fits"), {"TIME": G22_MET},
        header_extra={"MJDREFI": 55200, "MJDREFF": 0.0, "TIMEZERO": 0.0,
                      "TIMESYS": "TDB", "TELESCOP": "TEST"})
    rng = np.random.default_rng(11)
    met = rng.uniform(0.0, 5e7, 300)
    write_event_fits(
        str(work / "tt_events.fits"),
        {"TIME": met, "WEIGHT": rng.uniform(0, 1, 300),
         "ENERGY": rng.uniform(100, 3e5, 300)},
        header_extra={"MJDREFI": 51910, "MJDREFF": 7.428703703703703e-4,
                      "TIMEZERO": 1.5, "TIMESYS": "TT",
                      "TELESCOP": "GLAST"})
    (work / "tcb.par").write_text(PAR + "UNITS TCB\n")
    (work / "t2.par").write_text(PAR + T2_EXTRA)


_SCRIPT = r"""
import os, warnings
from pathlib import Path
import numpy as np
from mpmath import floor as mpfloor
from mpmath import mp, mpf
from ingest_env import golden_ingest_env
from oracle.mp_pipeline import OraclePulsar
from pint_tpu.event_toas import load_event_TOAs
from pint_tpu.io.fits import get_bintable
from pint_tpu.scripts import pintbary, photonphase, t2binary2pint, tcb2tdb
import contextlib, io

work = Path(os.environ["TORCH_TOOLS_WORK"])
data = Path("tests/datafile")
met = np.linspace(137.0, 85000.0, 25)
with golden_ingest_env():
    photonphase.main([str(work / "g22_events.fits"),
                      str(data / "golden22.par"),
                      "--outfile", str(work / "ref_phase.fits"),
                      "--log-level", "ERROR"])
    o = OraclePulsar(str(data / "golden22.par"), str(data / "golden22.tim"))
    orc = []
    with mp.workdps(30):
        for m_ in met:
            toa = dict(freq=mp.inf, day=55200, frac=mpf(float(m_)) / 86400,
                       err_us=mpf(1), obs="@", flags={})
            ph = o._absolute_phase(toa)[0] - o._tzr_phase()
            orc.append(float(ph - mpfloor(ph)))
OUT["g22/oracle"] = np.array(orc)
OUT["g22/ref_phase"] = np.asarray(
    get_bintable(str(work / "ref_phase.fits")).column("PULSE_PHASE"))

t = load_event_TOAs(str(work / "tt_events.fits"), mission="fermi",
                    weightcol="WEIGHT", energycol="ENERGY")
OUT["tt/day"] = t.t.mjd_int
OUT["tt/hi"] = t.t.sec.hi
OUT["tt/lo"] = t.t.sec.lo
OUT["tt/scale"] = np.array(t.t.scale)
OUT["tt/obs"] = np.array(t.obs)
OUT["tt/weight"] = np.array([f["weight"] for f in t.flags])
OUT["tt/energy"] = np.array([f["energy"] for f in t.flags])

buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    pintbary.main(BARY_ARGS + ["--log-level", "ERROR"])
OUT["bary"] = np.array(buf.getvalue())
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    tcb2tdb.main([str(work / "tcb.par"), str(work / "ref_tdb.par"),
                  "--log-level", "ERROR"])
    t2binary2pint.main([str(work / "t2.par"), str(work / "ref_t2.par"),
                        "--log-level", "ERROR"])
OUT["tdb_par"] = np.array((work / "ref_tdb.par").read_text())
OUT["t2_par"] = np.array((work / "ref_t2.par").read_text())
"""


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    w = tmp_path_factory.mktemp("torch_tools")
    _event_files(w)
    return w


@pytest.fixture(scope="module")
def ref(work):
    script = f"BARY_ARGS = {BARY_ARGS!r}\n" + textwrap.dedent(_SCRIPT)
    return run_reference(script, work / "ref.npz",
                         env={"TORCH_TOOLS_WORK": str(work)})


@pytest.fixture
def parfile(tmp_path):
    p = tmp_path / "test.par"
    p.write_text(PAR)
    return str(p)


def test_zima_pintempo_roundtrip(tmp_path, parfile, capsys):
    from pint_tpu_torch.scripts.pintempo import main as pintempo
    from pint_tpu_torch.scripts.zima import main as zima

    tim = str(tmp_path / "fake.tim")
    out = str(tmp_path / "fit.par")
    assert zima([parfile, tim, "--ntoa", "40", "--startMJD", "55000",
                 "--duration", "500", "--addnoise", "--seed", "42"]
                + CPU) == 0
    assert pintempo([parfile, tim, "--outfile", out] + CPU) == 0
    cap = capsys.readouterr()
    assert "chi2" in cap.out
    fitted = get_model(out)
    assert float(fitted.params["F0"].value.to_float()) == pytest.approx(
        245.4261196898081, abs=1e-9)


def test_compare_parfiles(tmp_path, parfile, capsys):
    from pint_tpu_torch.scripts.compare_parfiles import main

    p2 = tmp_path / "other.par"
    p2.write_text(PAR.replace("3.1380", "3.2000"))
    assert main([parfile, str(p2)] + CPU) == 0
    out = capsys.readouterr().out
    assert "DM" in out and "*" in out
    dm = next(line for line in out.splitlines() if line.startswith("DM "))
    assert dm.endswith("*") and "3.138" in dm and "3.2" in dm


def test_tcb2tdb_scaling(tmp_path, ref, work, capsys):
    """The reference's get_model warns as it converts a TCB par; the
    port's converts without a warning (a par read with warnings as errors
    must build, ``test_torch_components.py``), so this twin holds the
    converted values and the reference's output text instead."""
    from pint_tpu_torch.scripts.tcb2tdb import main

    par_tcb = tmp_path / "tcb.par"
    par_tcb.write_text(PAR + "UNITS TCB\n")
    out = tmp_path / "tdb.par"
    assert main([str(par_tcb), str(out)] + CPU) == 0
    m = get_model(str(out))
    assert (m.top_params["UNITS"].value or "TDB").upper() == "TDB"
    f0_tdb = float(m.params["F0"].value.to_float())
    # IAU/tempo2: F0_TDB = F0_TCB / (1-L_B) = F0_TCB * IFTE_K (larger)
    assert f0_tdb == pytest.approx(245.4261196898081 / (1.0 - L_B),
                                   rel=1e-12)
    assert f0_tdb > 245.4261196898081
    # the reference's output, string for string
    assert out.read_text() == str(ref["tdb_par"])


def test_pintbary_runs(ref, capsys):
    from pint_tpu_torch.scripts.pintbary import main

    assert main(BARY_ARGS + CPU) == 0
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    assert len(lines) == 2
    # barycentric time within +-600 s (Roemer + clock) of the input
    assert abs(float(lines[0]) - 55000.0) * 86400 < 700
    assert out == str(ref["bary"])


def test_fits_roundtrip(tmp_path):
    path = str(tmp_path / "ev.fits")
    time = np.linspace(0.0, 1000.0, 50)
    pi = np.arange(50, dtype=np.int32)
    write_event_fits(
        path, {"TIME": time, "PI": pi},
        header_extra={"MJDREFI": 56000, "MJDREFF": 0.25,
                      "TIMEZERO": 0.0, "TIMESYS": "TDB",
                      "TELESCOP": "NICER"},
    )
    hdu = get_bintable(path)
    assert hdu.name == "EVENTS"
    np.testing.assert_allclose(hdu.column("TIME"), time, rtol=1e-15)
    np.testing.assert_array_equal(hdu.column("PI"), pi)
    assert hdu.header["MJDREFI"] == 56000
    assert hdu.header["TIMESYS"] == "TDB"
    out = str(tmp_path / "ev2.fits")
    add_column(path, out, "PULSE_PHASE", np.linspace(0, 1, 50))
    h2 = get_bintable(out)
    assert "PULSE_PHASE" in h2.columns()
    np.testing.assert_allclose(h2.column("TIME"), time, rtol=1e-15)
    assert h2.header["MJDREFF"] == 0.25 and h2.header["TELESCOP"] == "NICER"


def test_event_toas_and_photonphase(tmp_path, parfile, capsys):
    from pint_tpu_torch.event_toas import load_event_TOAs
    from pint_tpu_torch.scripts.photonphase import main as photonphase
    from pint_tpu_torch.toas.ingest import ingest_barycentric

    # pulsed barycentric events from the model itself: uniform times,
    # photons kept near model phase 0.3
    m = get_model(parfile)
    rng = np.random.default_rng(7)
    met = np.sort(rng.uniform(0, 2000.0, 6000))
    mjdref = 55000.0
    path = str(tmp_path / "events.fits")
    hdr = {"MJDREFI": 55000, "MJDREFF": 0.0, "TIMEZERO": 0.0,
           "TIMESYS": "TDB", "TELESCOP": "TEST"}
    write_event_fits(path, {"TIME": met}, header_extra=hdr)
    toas = load_event_TOAs(path)
    assert len(toas) == 6000
    assert toas.obs[0] == "@"
    np.testing.assert_allclose(toas.mjd_float(),
                               mjdref + np.sort(met) / 86400.0, rtol=1e-12)
    ingest_barycentric(toas)
    cm = m.compile(toas, device="cpu", subtract_mean=False)
    phases = np.mod(cm.phase(cm.x0()).frac.numpy(), 1.0)
    keep = (rng.uniform(size=len(phases))
            < 0.15 + np.exp(-0.5 * ((phases - 0.3) / 0.04) ** 2))
    write_event_fits(path, {"TIME": met[keep]}, header_extra=hdr)
    out = str(tmp_path / "events_phase.fits")
    assert photonphase([path, parfile, "--outfile", out] + CPU) == 0
    cap = capsys.readouterr().out
    h = float(cap.split("Htest :")[1].split()[0])
    assert h > 200.0
    ph_out = get_bintable(out).column("PULSE_PHASE")
    # the written phases must peak near 0.3
    hist, edges = np.histogram(ph_out, bins=20, range=(0, 1))
    assert 0.25 < edges[np.argmax(hist)] < 0.35


def test_photonphase_uniform_low_h(tmp_path, parfile, capsys):
    from pint_tpu_torch.scripts.photonphase import main as photonphase

    rng = np.random.default_rng(1)
    met = np.sort(rng.uniform(0, 2000.0, 3000))
    path = str(tmp_path / "uniform.fits")
    write_event_fits(
        path, {"TIME": met},
        header_extra={"MJDREFI": 55000, "MJDREFF": 0.0, "TIMEZERO": 0.0,
                      "TIMESYS": "TDB"},
    )
    assert photonphase([path, parfile] + CPU) == 0
    h = float(capsys.readouterr().out.split("Htest :")[1].split()[0])
    assert h < 30.0


def test_logging_dedup(capsys):
    import pint_tpu_torch.logging as plog

    log = plog.setup("INFO")
    for _ in range(5):
        log.warning("repeated clock warning about site xyz")
    log.warning("a different message")
    err = capsys.readouterr().err
    assert err.count("repeated clock warning") == 1
    assert "a different message" in err
    # reset between fits: the same message passes once more
    plog.reset_dedup()
    log.warning("repeated clock warning about site xyz")
    assert capsys.readouterr().err.count("repeated clock warning") == 1


def test_photonphase_tzr_absolute_phase_vs_oracle(ref, work, capsys):
    """golden22's TZR-anchored model on the photonphase path: the written
    PULSE_PHASE equals the independent mpmath oracle's TZR-anchored
    absolute phase mod 1 within 1e-6 cycles (the reference test's gate),
    and the reference's own photonphase output within 1e-12 cycles; the
    anchor crosses the gbt clock/EOP/SPK chain on every side."""
    from pint_tpu_torch.scripts.photonphase import main as photonphase

    out = str(work / "g22_events_phase.fits")
    with port_ingest_env(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert photonphase([str(work / "g22_events.fits"),
                            str(DATADIR / "golden22.par"), "--outfile",
                            out] + CPU) == 0
    capsys.readouterr()
    ph_out = np.asarray(get_bintable(out).column("PULSE_PHASE"))

    def circ(a, b):
        d = np.abs(a - b)
        return np.minimum(d, 1.0 - d)  # circular distance in cycles

    assert circ(ph_out, ref["g22/oracle"]).max() < 1e-6
    assert circ(ph_out, ref["g22/ref_phase"]).max() < 1e-12


def test_load_event_toas_matches_reference(ref, work):
    """A TT event file at the geocentre (MJDREFF and TIMEZERO nonzero,
    weights and energies in columns): the port's TOAs equal the
    reference's bitwise, the exact MJD split and TT->UTC included."""
    from pint_tpu_torch.event_toas import (
        get_event_energies,
        get_event_weights,
        load_event_TOAs,
    )

    t = load_event_TOAs(str(work / "tt_events.fits"), mission="fermi",
                        weightcol="WEIGHT", energycol="ENERGY")
    assert t.t.scale == str(ref["tt/scale"]) == "utc"
    np.testing.assert_array_equal(t.t.mjd_int, ref["tt/day"])
    np.testing.assert_array_equal(t.t.sec.hi, ref["tt/hi"])
    np.testing.assert_array_equal(t.t.sec.lo, ref["tt/lo"])
    assert t.obs == list(ref["tt/obs"]) and t.obs[0] == "0"
    assert [f["weight"] for f in t.flags] == list(ref["tt/weight"])
    assert [f["energy"] for f in t.flags] == list(ref["tt/energy"])
    np.testing.assert_array_equal(
        get_event_weights(t), ref["tt/weight"].astype(float))
    np.testing.assert_array_equal(
        get_event_energies(t), ref["tt/energy"].astype(float))
    assert np.all(np.isinf(t.freq)) and np.all(t.error_us == 0.0)


def test_t2binary2pint(tmp_path, ref, work, capsys):
    from pint_tpu_torch.scripts.t2binary2pint import main

    par = tmp_path / "t2.par"
    par.write_text(PAR + T2_EXTRA)
    out = tmp_path / "pint.par"
    assert main([str(par), str(out)] + CPU) == 0
    m = get_model(str(out))
    assert "BinaryELL1" in m.components
    assert out.read_text() == str(ref["t2_par"])


def test_pintpublish(tmp_path, capsys):
    from pint_tpu_torch.io.tim import write_tim_file
    from pint_tpu_torch.scripts.pintpublish import main
    from pint_tpu_torch.simulation import make_test_pulsar

    m, toas = make_test_pulsar(PAR, ntoa=40, obs="@", device="cpu")
    par = tmp_path / "p.par"
    par.write_text(PAR)
    tim = tmp_path / "p.tim"
    write_tim_file(str(tim), toas)
    assert main([str(par), str(tim)] + CPU) == 0
    out = capsys.readouterr().out
    assert "Weighted RMS" in out and "Characteristic age" in out
    assert main([str(par), str(tim), "--latex"] + CPU) == 0
    assert "tabular" in capsys.readouterr().out


def test_event_optimize_recovers_f0(tmp_path, capsys):
    """Pulsed photons from the truth; F0 started off; the sampler must
    move the model back to the true F0 (the reference test's gate),
    every step one replay of the step program."""
    from pint_tpu_torch import sampler
    from pint_tpu_torch.event_toas import load_event_TOAs
    from pint_tpu_torch.scripts import event_optimize
    from pint_tpu_torch.toas.ingest import ingest_barycentric

    rng = np.random.default_rng(4)
    m_true = get_model(PAR)
    met = np.sort(rng.uniform(0, 3000.0, 8000))
    path = str(tmp_path / "ev.fits")
    hdr = {"MJDREFI": 55000, "MJDREFF": 0.0, "TIMEZERO": 0.0,
           "TIMESYS": "TDB"}
    write_event_fits(path, {"TIME": met}, header_extra=hdr)
    toas = load_event_TOAs(path)
    ingest_barycentric(toas)
    cm = m_true.compile(toas, device="cpu", subtract_mean=False)
    phases = np.mod(cm.phase(cm.x0()).frac.numpy(), 1.0)
    keep = (rng.uniform(size=len(phases))
            < 0.1 + np.exp(-0.5 * ((phases - 0.5) / 0.05) ** 2))
    write_event_fits(path, {"TIME": met[keep]}, header_extra=hdr)
    # F0 off by ~0.3 cycles over the 3000 s span, F0-only
    par_fit = tmp_path / "fit.par"
    par_fit.write_text(
        "PSR J1744-1134\nF0 245.42621968980 1\nPEPOCH 55000\nDM 3.138\n")
    gauss = tmp_path / "template.gauss"
    gauss.write_text(
        "const = 0.5\nphas1 = 0.5\nfwhm1 = 0.117741\nampl1 = 0.5\n")
    out = tmp_path / "post.par"
    runs = []
    real = sampler.run_ensemble

    def spy(*a, **kw):
        # the steps run through the compiled model's program cache (on
        # the card, one replay a step: chip_smoke.py's phase 15)
        runs.append((a[0], kw["programs"], kw["device"]))
        return real(*a, **kw)

    sampler.run_ensemble = spy
    try:
        assert event_optimize.main([
            path, str(par_fit), str(gauss), "--nsteps", "400",
            "--nwalkers", "16", "--outfile", str(out), "--seed", "1",
        ] + CPU) == 0
    finally:
        sampler.run_ensemble = real
    assert len(runs) == 1 and runs[0][1] is not None
    assert runs[0][2] == torch.device("cpu")
    m_post = get_model(str(out))
    f0 = float(m_post.params["F0"].value.to_float())
    # true F0 245.4261196898081; the start was off by +1e-4
    assert abs(f0 - 245.4261196898081) < 3e-5


def test_build_lnpost_is_vmap_safe():
    """The log-posterior of a batch of walkers under ``torch.func.vmap``
    equals the walkers' single evaluations (a step is one program)."""
    from pint_tpu_torch.scripts.event_optimize import build_lnpost
    from pint_tpu_torch.simulation import make_test_pulsar
    from pint_tpu_torch.templates import LCGaussian, LCTemplate

    m, toas = make_test_pulsar(PAR, ntoa=200, obs="@", device="cpu")
    cm = m.compile(toas, device="cpu", subtract_mean=False)
    tmpl = LCTemplate([LCGaussian(width=0.05, loc=0.5)], weights=[0.5])
    w = np.random.default_rng(0).uniform(0, 1, 200)
    lnpost = build_lnpost(cm, tmpl, w)
    xs = torch.as_tensor(np.random.default_rng(1).normal(
        0, 1e-12, (6, cm.nfree)))
    batched = torch.func.vmap(lnpost)(xs)
    single = torch.stack([lnpost(x) for x in xs])
    assert torch.allclose(batched, single, rtol=1e-13, atol=0.0)


def test_tools_default_to_the_card(tmp_path, parfile):
    """Without ``--device`` every tool means the card, and raises where
    there is none rather than running on the host."""
    from pint_tpu_torch.io.tim import write_tim_file
    from pint_tpu_torch.polycos import Polycos
    from pint_tpu_torch.scripts import (
        compare_parfiles,
        pintbary,
        pintempo,
        tcb2tdb,
        zima,
    )
    from pint_tpu_torch.simulation import make_test_pulsar

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    _, toas = make_test_pulsar(PAR, ntoa=20, obs="@", device="cpu")
    tim = str(tmp_path / "p.tim")
    write_tim_file(tim, toas)
    quiet = ["--log-level", "ERROR"]
    for run in (
        lambda: zima.main([parfile, str(tmp_path / "z.tim")] + quiet),
        lambda: pintempo.main([parfile, tim] + quiet),
        lambda: pintbary.main(BARY_ARGS + quiet),
        lambda: compare_parfiles.main([parfile, parfile] + quiet),
        lambda: tcb2tdb.main([parfile, str(tmp_path / "o.par")] + quiet),
        lambda: Polycos.generate(get_model(PAR), 55000.0, 55000.1),
        lambda: get_model(PAR).delay(toas),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
