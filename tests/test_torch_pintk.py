"""The port's interactive session layer, plots and host utilities.

- Twins of every test of ``tests/test_pintk_globalclock.py``: the
  ``Pulsar`` session (fit, delete, undo, jumps, random models, paredit
  and timedit roundtrips), the global clock manager and the
  ``TimingModel`` convenience API (``delay``, ``phase``,
  ``designmatrix``, ``d_phase_d_param`` on ``device``).
- Twins of ``tests/test_utils_cache_plots.py``'s ``weighted_mean``,
  ``dmxparse``, ``compute_hash``, TOA-cache, ``CombinedResiduals`` and
  plotting tests (matplotlib on Agg, as the reference's).
- Against the reference on the same inputs: ``weighted_mean``,
  ``split_intervals`` and ``dmxparse`` bitwise; the convenience API's
  delay within 1e-15 s, its design matrix within 1e-9 of its columns'
  largest values and ``d_phase_d_param`` within 1e-9 relative.

The reference runs once for the module in a subprocess
(tests/torch_reference.py).
"""

import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import run_reference  # noqa: E402

from pint_tpu_torch.io.tim import write_tim_file  # noqa: E402
from pint_tpu_torch.models.builder import get_model  # noqa: E402
from pint_tpu_torch.simulation import make_test_pulsar  # noqa: E402

PAR = """PSR J1744-1134
F0 245.4261196898081 1
F1 -5.38e-16 1
PEPOCH 55000
DM 3.1380 1
"""
DMX_PAR = PAR + """
DMX_0001 1e-3 1
DMXR1_0001 54000
DMXR2_0001 55000
DMX_0002 -2e-3 1
DMXR1_0002 55000
DMXR2_0002 56000
"""
VALUES = [1.0, 3.0, 2.5, -0.5]
ERRORS = [1.0, 1.0, 0.5, 2.0]
GROUP_MJDS = [1.0, 1.1, 5.0, 5.2, 9.0]

_SCRIPT = r"""
from pint_tpu.models.builder import get_model
from pint_tpu.simulation import make_test_pulsar
from pint_tpu.utils import dmxparse, split_intervals, weighted_mean

OUT["wmean"] = np.array(weighted_mean(VALUES, ERRORS, dof=True))
OUT["groups"] = np.array(split_intervals(GROUP_MJDS, gap_days=1.0))
d = dmxparse(get_model(DMX_PAR))
for k, v in d.items():
    OUT[f"dmx/{k}"] = np.asarray(v)
m, toas = make_test_pulsar(PAR, ntoa=30)
OUT["api/day"] = toas.t.mjd_int
OUT["api/hi"] = toas.t.sec.hi
OUT["api/lo"] = toas.t.sec.lo
OUT["api/delay"] = m.delay(toas)
ints, frac = m.phase(toas)
OUT["api/int"], OUT["api/frac"] = ints, frac
M, names = m.designmatrix(toas)
OUT["api/M"] = M
META["names"] = names
OUT["api/dpdf0"] = m.d_phase_d_param(toas, "F0")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_pintk")
    script = (f"PAR = {PAR!r}\nDMX_PAR = {DMX_PAR!r}\nVALUES = {VALUES!r}\n"
              f"ERRORS = {ERRORS!r}\nGROUP_MJDS = {GROUP_MJDS!r}\n"
              + textwrap.dedent(_SCRIPT))
    return run_reference(script, work / "ref.npz")


@pytest.fixture
def session_files(tmp_path):
    m, toas = make_test_pulsar(PAR, ntoa=60, jitter_us=1.0, obs="@",
                               device="cpu")
    # an outlier to delete
    toas.t = toas.t.add_seconds(np.where(np.arange(60) == 30, 5e-5, 0.0))
    from pint_tpu_torch.toas.ingest import ingest_barycentric

    ingest_barycentric(toas)
    par = tmp_path / "p.par"
    par.write_text(PAR)
    tim = tmp_path / "p.tim"
    write_tim_file(str(tim), toas)
    return str(par), str(tim)


def test_pulsar_fit_delete_undo(session_files):
    from pint_tpu_torch.pintk import Pulsar

    par, tim = session_files
    psr = Pulsar(par, tim, device="cpu")
    assert len(psr.all_toas) == 60
    r0 = psr.residuals()
    chi2_before = r0.chi2
    # the outlier dominates: delete it, fit, chi2 collapses
    outlier = int(np.argmax(np.abs(r0.time_resids)))
    psr.delete_toas([outlier])
    assert len(psr.selected_toas) == 59
    chi2 = psr.fit()
    assert chi2 < chi2_before / 10
    f0_fit = float(psr.model.params["F0"].value.to_float())
    # undo returns the pre-fit model
    psr.undo_fit()
    assert float(psr.model.params["F0"].value.to_float()) == pytest.approx(
        245.4261196898081, abs=1e-12)
    psr.restore_toas()
    assert len(psr.selected_toas) == 60
    psr.reset_model()
    assert psr.fitter is None
    assert abs(f0_fit - 245.4261196898081) < 1e-7


def test_pulsar_add_jump(session_files):
    from pint_tpu_torch.pintk import Pulsar

    par, tim = session_files
    psr = Pulsar(par, tim, device="cpu")
    name = psr.add_jump(np.arange(10, 20))
    assert name.startswith("JUMP")
    assert "PhaseJump" in psr.model.components
    p = psr.model.params[name]
    assert not p.frozen
    sel = p.select(psr.all_toas)
    assert sel[10:20].all() and sel.sum() == 10
    chi2 = psr.fit()
    assert np.isfinite(chi2)
    assert psr.random_models(5).shape == (5, 60)


def test_global_clock_update(tmp_path):
    from pint_tpu_torch.observatory.global_clock import (
        Index,
        update_clock_files,
    )

    repo = tmp_path / "repo"
    (repo / "t2").mkdir(parents=True)
    (repo / "t2" / "gbt2gps.clk").write_text(
        "# UTC(gbt) UTC(gps)\n50000 1e-6\n60000 1e-6\n")
    (repo / "index.txt").write_text(
        "# file update valid-end\nt2/gbt2gps.clk 60000.0 60200.0\n")
    dest = tmp_path / "clk"
    installed = update_clock_files(repo, clock_dir=dest, now_mjd=60050.0)
    assert installed == ["gbt2gps.clk"]
    assert (dest / "gbt2gps.clk").exists()
    with pytest.warns(UserWarning, match="stale"):
        update_clock_files(repo, clock_dir=dest, now_mjd=60500.0)
    idx = Index.from_file(repo / "index.txt")
    assert idx.stale_files(60500.0) == ["t2/gbt2gps.clk"]
    assert idx.stale_files(60050.0) == []


def test_timing_model_convenience_api(ref):
    from pint_tpu_torch.constants import DM_CONST
    from pint_tpu_torch.exceptions import TimingModelError

    m, toas = make_test_pulsar(PAR, ntoa=30, obs="@", device="cpu")
    # the reference's simulated TOAs, bit for bit
    np.testing.assert_array_equal(toas.t.mjd_int, ref["api/day"])
    np.testing.assert_array_equal(toas.t.sec.hi, ref["api/hi"])
    np.testing.assert_array_equal(toas.t.sec.lo, ref["api/lo"])
    d = m.delay(toas, device="cpu")
    assert d.shape == (30,)
    # barycentric sim: the delay is the dispersion term
    np.testing.assert_allclose(d, DM_CONST * 3.138 / toas.freq**2,
                               rtol=1e-9)
    np.testing.assert_allclose(d, ref["api/delay"], rtol=0.0, atol=1e-15)
    ints, frac = m.phase(toas, device="cpu")
    assert np.all(np.abs(frac) <= 0.5)
    np.testing.assert_array_equal(ints, ref["api/int"])
    np.testing.assert_allclose(frac, ref["api/frac"], rtol=0.0, atol=1e-12)
    M, names = m.designmatrix(toas, device="cpu")
    assert M.shape == (30, 3) and set(names) == {"F0", "F1", "DM"}
    assert names == ref["__meta__"]["names"]
    scale = np.max(np.abs(ref["api/M"]), axis=0)
    assert np.max(np.abs(M - ref["api/M"]) / scale) < 1e-9
    dpdf0 = m.d_phase_d_param(toas, "F0", device="cpu")
    # d phase / d F0 = dt (seconds from PEPOCH, delay-corrected)
    dt = (toas.mjd_float() - 55000.0) * 86400.0
    np.testing.assert_allclose(dpdf0, dt, rtol=1e-6)
    np.testing.assert_allclose(dpdf0, ref["api/dpdf0"], rtol=1e-9)
    with pytest.raises(TimingModelError):
        m.d_phase_d_param(toas, "PX", device="cpu")


def test_paredit_roundtrip_refit(session_files):
    """Edit the par text, apply, refit: the edit survives, and undo
    restores the pre-edit model (reference: pintk/paredit.py)."""
    from pint_tpu_torch.pintk import Pulsar

    par, tim = session_files
    psr = Pulsar(par, tim, device="cpu")
    chi2_0 = psr.fit()
    text = psr.get_par_text()
    assert "F0" in text and "DM" in text
    # edit: perturb F0 and freeze DM
    lines = []
    for line in text.splitlines():
        if line.startswith("F0"):
            toks = line.split()
            lines.append(f"F0 {float(toks[1]) + 2e-9:.19g} 1")
        elif line.startswith("DM "):
            toks = line.split()
            lines.append(f"DM {toks[1]}")  # no fit flag -> frozen
        else:
            lines.append(line)
    psr.edit_par("\n".join(lines))
    assert psr.model.params["DM"].frozen
    chi2_edit = float(psr.residuals().chi2)
    assert chi2_edit > chi2_0 + 1.0  # the F0 bump must hurt
    chi2_refit = psr.fit()
    assert chi2_refit < chi2_edit
    # the refit pulled F0 back (DM frozen stays put)
    f0 = psr.model.params["F0"].value
    f0 = float(f0.to_float() if hasattr(f0, "to_float") else f0)
    assert abs(f0 - 245.4261196898081) < 5e-10
    # undo twice: refit -> edited state; edit -> original model
    psr.undo_fit()
    assert psr.model.params["DM"].frozen
    psr.undo_fit()
    assert not psr.model.params["DM"].frozen


def test_timedit_roundtrip(session_files):
    """tim text round-trips through get_tim_text/edit_tim; an edit that
    drops TOAs re-ingests and refits cleanly (reference:
    pintk/timedit.py)."""
    from pint_tpu_torch.pintk import Pulsar

    par, tim = session_files
    psr = Pulsar(par, tim, device="cpu")
    n0 = len(psr.all_toas)
    text = psr.get_tim_text()
    psr.edit_tim(text)  # re-apply unchanged text
    assert len(psr.all_toas) == n0
    assert psr.get_tim_text() == text
    # drop the outlier line (index 30) and refit
    lines = text.splitlines()
    del lines[31]  # line 0 is FORMAT 1
    psr.edit_tim("\n".join(lines) + "\n")
    assert len(psr.all_toas) == n0 - 1
    assert np.isfinite(psr.fit())


def test_weighted_mean_and_intervals(ref):
    from pint_tpu_torch.utils import split_intervals, weighted_mean

    m, e = weighted_mean([1.0, 3.0], [1.0, 1.0])
    assert m == 2.0 and e == pytest.approx(1 / np.sqrt(2))
    m, e, red = weighted_mean([1.0, 3.0], [1.0, 1.0], dof=True)
    assert red == pytest.approx(2.0)
    groups = split_intervals([1.0, 1.1, 5.0, 5.2, 9.0], gap_days=1.0)
    assert groups == [(0, 2), (2, 4), (4, 5)]
    np.testing.assert_array_equal(
        weighted_mean(VALUES, ERRORS, dof=True), ref["wmean"])
    np.testing.assert_array_equal(
        split_intervals(GROUP_MJDS, gap_days=1.0), ref["groups"])


def test_dmxparse(ref):
    from pint_tpu_torch.utils import dmxparse

    out = dmxparse(get_model(DMX_PAR))
    np.testing.assert_allclose(out["dmxs"], [1e-3, -2e-3])
    np.testing.assert_allclose(out["dmx_epochs"], [54500, 55500])
    assert out["mean_dmx"] == pytest.approx(-5e-4)
    assert sorted(out) == sorted(k[4:] for k in ref if k.startswith("dmx/"))
    for k, v in out.items():
        np.testing.assert_array_equal(np.asarray(v), ref[f"dmx/{k}"], k)


def test_compute_hash(tmp_path):
    from pint_tpu_torch.utils import compute_hash

    p = tmp_path / "a.txt"
    p.write_text("hello")
    h1 = compute_hash(str(p), "opts")
    assert h1 == compute_hash(str(p), "opts")
    assert h1 != compute_hash(str(p), "other")
    p.write_text("changed")
    assert h1 != compute_hash(str(p), "opts")


def test_toa_cache_roundtrip(tmp_path, monkeypatch):
    from pint_tpu_torch.toas.cache import get_TOAs

    monkeypatch.setenv("PINT_TPU_CACHE_DIR", str(tmp_path))
    m, toas = make_test_pulsar(PAR, ntoa=30, obs="@", device="cpu")
    tim = tmp_path / "c.tim"
    write_tim_file(str(tim), toas)
    t1 = get_TOAs(str(tim), model=m, usepickle=True)
    assert (tmp_path / "c.tim.torch-ingest.npz").exists()
    t2 = get_TOAs(str(tim), model=m, usepickle=True)  # cache hit
    np.testing.assert_array_equal(t1.t_tdb.mjd_int, t2.t_tdb.mjd_int)
    np.testing.assert_array_equal(t1.t_tdb.sec.hi, t2.t_tdb.sec.hi)
    np.testing.assert_array_equal(t1.t_tdb.sec.lo, t2.t_tdb.sec.lo)
    assert t2.flags[0] == t1.flags[0]
    # the cache is keyed on the tim content
    write_tim_file(str(tim), toas[:20])
    assert len(get_TOAs(str(tim), model=m, usepickle=True)) == 20


def test_combined_residuals():
    from pint_tpu_torch.residuals import CombinedResiduals, Residuals

    m1, t1 = make_test_pulsar(PAR, ntoa=30, seed=1, obs="@", device="cpu")
    m2, t2 = make_test_pulsar(PAR, ntoa=20, seed=2, obs="@", device="cpu")
    r1 = Residuals(t1, m1, device="cpu")
    r2 = Residuals(t2, m2, device="cpu")
    c = CombinedResiduals([r1, r2])
    assert c.chi2 == pytest.approx(r1.chi2 + r2.chi2)
    assert c.dof == r1.dof + r2.dof
    assert c.reduced_chi2 == pytest.approx(c.chi2 / c.dof)
    assert len(c) == 50


def test_plot_utils_smoke(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    from pint_tpu_torch.fitting import WLSFitter
    from pint_tpu_torch.plot_utils import (
        phaseogram,
        plot_random_models,
        plot_residuals,
    )
    from pint_tpu_torch.residuals import Residuals

    m, toas = make_test_pulsar(PAR, ntoa=40, obs="@", device="cpu")
    phaseogram(toas.mjd_float(), np.random.default_rng(0).uniform(size=40),
               plotfile=str(tmp_path / "pg.png"))
    assert (tmp_path / "pg.png").exists()
    plot_residuals(toas, Residuals(toas, m, device="cpu"),
                   plotfile=str(tmp_path / "r.png"))
    assert (tmp_path / "r.png").exists()
    f = WLSFitter(toas, m, device="cpu")
    f.fit_toas()
    plot_random_models(f, n_models=5, plotfile=str(tmp_path / "rm.png"))
    assert (tmp_path / "rm.png").exists()


def test_pintempo_plotfile_and_missing_matplotlib(tmp_path, monkeypatch,
                                                  capsys):
    """pintempo's --plotfile writes a plot on Agg; where matplotlib is
    missing, only the plotting call raises ImportError."""
    from pint_tpu_torch.plot_utils import phaseogram
    from pint_tpu_torch.scripts.pintempo import main as pintempo

    m, toas = make_test_pulsar(PAR, ntoa=30, obs="@", device="cpu")
    par = tmp_path / "p.par"
    par.write_text(PAR)
    tim = tmp_path / "p.tim"
    write_tim_file(str(tim), toas)
    png = tmp_path / "post.png"
    assert pintempo([str(par), str(tim), "--plotfile", str(png),
                     "--device", "cpu", "--log-level", "ERROR"]) == 0
    assert png.exists()
    capsys.readouterr()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        phaseogram([55000.0], [0.5], plotfile=str(tmp_path / "x.png"))
