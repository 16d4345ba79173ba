"""Parity of the port's remaining narrowband timing-model components with
the JAX package.

Solar wind (NE_SW with its Taylor terms, SWX), glitches, Wave and WaveX /
DMWaveX / CMWaveX, IFUNC, piecewise spindown, ChromaticCM, troposphere,
the TZR anchor, PHOFF, UNITS TCB, and the power-law DM and chromatic
noise: on goldens 6, 7, 16, 18-23 (16, 21 and 22 ingested through the
committed clock/EOP/ephemeris data), on synthetic pars for what no golden
covers, and on ``simulation.msp_full_par`` at 2048 TOAs with 12 DMX
ranges, the chip path's configuration cut in depth.  The reference runs
once per module in a subprocess (tests/torch_reference.py); its state,
the TZR row included, is carried across with
``pint_tpu_torch.convert.state_from_numpy``, so both packages compute on
byte-identical inputs.  Tolerances are stated per test.
"""

import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import load_state, run_reference  # noqa: E402

from pint_tpu_torch.convert import state_from_numpy  # noqa: E402
from pint_tpu_torch.exceptions import PintTpuError  # noqa: E402
from pint_tpu_torch.fitting.base import design_with_offset  # noqa: E402
from pint_tpu_torch.fitting.gls import (  # noqa: E402
    GLSFitter,
    gls_step_woodbury,
    gls_step_woodbury_mixed,
)
from pint_tpu_torch.models.builder import get_model  # noqa: E402
from pint_tpu_torch.models.timing_model import (  # noqa: E402
    reference_values,
)
from pint_tpu_torch.simulation import (  # noqa: E402
    MSP_FREQS,
    make_test_pulsar,
    msp_full_par,
)
from pint_tpu_torch.timebase.hostdd import HostDD  # noqa: E402

DATADIR = Path(__file__).parent / "datafile"
GOLDENS = ["golden6", "golden7", "golden16", "golden18", "golden19",
           "golden20", "golden21", "golden22", "golden23"]
INGESTED = ("golden16", "golden21", "golden22")


def _par(stem):
    return (DATADIR / f"{stem}.par").read_text()


#: synthetic sets: name -> (par text, the golden whose TOAs it uses)
SYNTH = {
    # PHOFF free replaces the implicit offset column; under a TZR anchor
    # the reference subtracts it from the TZR row's phase as well
    "phoff": (_par("golden20") + "PHOFF 0.0 1\n", "golden20"),
    "phoff_tzr": (_par("golden22") + "PHOFF 0.0 1\n", "golden22"),
    # chromatic noise at the default index and at ChromaticCM's CMIDX
    "chrom": (_par("golden18").replace("TNDM", "TNCHROM"), "golden18"),
    "chrom_idx": (_par("golden18").replace("TNDM", "TNCHROM")
                  + "CMIDX 3.3\n", "golden18"),
    # the solar wind's Taylor terms
    "nesw1": (_par("golden6") + "NE_SW1 0.8 1\nNE_SW2 -0.1\n"
              "SWEPOCH 55500\n", "golden6"),
    # IFUNC's nearest-node modes, and a glitch with GLF2
    "sifunc1": (_par("golden7").replace("SIFUNC 2", "SIFUNC 1"), "golden7"),
    "sifunc0": (_par("golden7").replace("SIFUNC 2", "SIFUNC 0"), "golden7"),
    "glf2": (_par("golden7") + "GLF2_1 -3e-21 1\n", "golden7"),
}
MSP_NDMX = 12
MSP_NTOA = 2048
MSP_FULL = msp_full_par(MSP_NDMX, seed=0)
STATES = GOLDENS + list(SYNTH) + ["msp_full"]
#: goldens whose residuals need the reference's ingest environment
PARREF = GOLDENS + ["msp_full"]

_SCRIPT = textwrap.dedent(f"""
import contextlib
import warnings
import jax.numpy as jnp
from ingest_env import golden_ingest_env
import pint_tpu.fitting.gls as rgls
from pint_tpu.constants import AU, SECS_PER_DAY
from pint_tpu.fitting.base import design_with_offset
from pint_tpu.models.builder import get_model, get_model_and_toas
from pint_tpu.models.timing_model import reference_values
from pint_tpu.simulation import make_test_pulsar
from pint_tpu.timebase.hostdd import HostDD

def env(stem):
    return (golden_ingest_env() if stem in {INGESTED!r}
            else contextlib.nullcontext())

def record(name, cm):
    export_state(cm, name)
    x0 = cm.x0()
    OUT[f"res/{{name}}/resid"] = np.asarray(cm.time_residuals(x0))
    OUT[f"res/{{name}}/design"] = np.asarray(cm.design_matrix(x0))
    bw = cm.noise_basis(x0)
    if bw is not None:
        OUT[f"res/{{name}}/T"] = np.asarray(bw[0])
        OUT[f"res/{{name}}/phi"] = np.asarray(bw[1])

def parref(name, model):
    for n, v in reference_values(model).items():
        if isinstance(v, HostDD):
            OUT[f"parref/{{name}}/{{n}}"] = np.array([v.hi, v.lo], float)
        elif isinstance(v, tuple) and isinstance(v[1], HostDD):
            OUT[f"parref/{{name}}/{{n}}"] = np.array(
                [v[0], v[1].hi, v[1].lo], float)
        elif isinstance(v, tuple):
            OUT[f"parref/{{name}}/{{n}}"] = np.array(v, float)
        elif not isinstance(v, (bool, str)):
            OUT[f"parref/{{name}}/{{n}}"] = np.array([v], float)

for stem in {GOLDENS!r}:
    with warnings.catch_warnings(), env(stem):
        warnings.simplefilter("ignore")
        model, toas = get_model_and_toas(f"tests/datafile/{{stem}}.par",
                                         f"tests/datafile/{{stem}}.tim")
        record(stem, model.compile(toas))
        parref(stem, get_model(f"tests/datafile/{{stem}}.par"))
for name, (par, stem) in {SYNTH!r}.items():
    with warnings.catch_warnings(), env(stem):
        warnings.simplefilter("ignore")
        model, toas = get_model_and_toas(par, f"tests/datafile/{{stem}}.tim")
        record(name, model.compile(toas))

# the full-width MSP, cut to 12 DMX ranges and 2048 TOAs, simulated and
# given the synthetic 1-AU orbit as bench.py, with the Sun at the SSB
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    model, toas = make_test_pulsar({MSP_FULL!r}, ntoa={MSP_NTOA},
                                   start_mjd=53000.0, end_mjd=57500.0,
                                   seed=0, iterations=1,
                                   freqs={MSP_FREQS!r})
ph = 2 * np.pi * (toas.t.mjd_int + toas.t.sec.to_float() / SECS_PER_DAY
                  - 53000.0) / 365.25
toas.ssb_obs_pos = np.stack([AU * np.cos(ph), AU * np.sin(ph),
                             np.zeros_like(ph)], axis=-1)
toas.obs_sun_pos = -toas.ssb_obs_pos
cm = model.compile(toas)
record("msp_full", cm)
parref("msp_full", get_model({MSP_FULL!r}))
x0 = cm.x0()
dx, (covn, _), chi2, nbad = rgls.gls_step_woodbury(
    cm.time_residuals(x0, subtract_mean=False), design_with_offset(cm, x0),
    jnp.square(cm.scaled_sigma(x0)), *cm.noise_basis_or_empty(x0),
    normalized_cov=True)
OUT["step/dx"] = np.asarray(dx)
OUT["step/covn"] = np.asarray(covn)
OUT["step/chi2"] = np.asarray(chi2)
OUT["step/nbad"] = np.asarray(nbad)
try:
    rgls.GLSFitter(toas, get_model({MSP_FULL!r}), fused=True).fit_toas(
        maxiter=1)
except Exception as e:
    META["fused_error"] = type(e).__name__ + ": " + str(e)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    return run_reference(_SCRIPT, d / "components.npz", timeout=900)


@pytest.fixture(scope="module")
def compiled(ref):
    """name -> the port's CompiledModel on the reference's state (CPU)."""
    cache = {}

    def get(name):
        if name not in cache:
            model, bundle, _ = state_from_numpy(load_state(ref, name),
                                                device="cpu")
            cache[name] = model.compile(bundle)
        return cache[name]

    return get


def _col_rel(got, want):
    """Worst column of |got - want| over the column's own max."""
    scale = np.max(np.abs(want), axis=0)
    scale = np.where(scale == 0, 1.0, scale)
    return float(np.max(np.max(np.abs(got - want), axis=0) / scale))


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _flat(v):
    if isinstance(v, HostDD):
        return [float(v.hi), float(v.lo)]
    if isinstance(v, tuple) and isinstance(v[1], HostDD):
        return [float(v[0]), float(v[1].hi), float(v[1].lo)]
    if isinstance(v, tuple):
        return [float(v[0]), float(v[1])]
    return [float(v)]


@pytest.mark.parametrize("stem", GOLDENS)
def test_golden_residuals_match_oracle(compiled, stem):
    """The port's residuals on each golden's state against its committed
    oracle: < 1 ns, the golden regression bar."""
    cm = compiled(stem)
    oracle = np.load(DATADIR / f"{stem}_oracle.npz")
    r = cm.time_residuals(cm.x0()).numpy()
    np.testing.assert_allclose(r, oracle["resid"], rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", STATES)
def test_residuals_match_reference(ref, compiled, name):
    """Residuals on the same state within 1e-11 s of the reference's."""
    cm = compiled(name)
    r = cm.time_residuals(cm.x0()).numpy()
    np.testing.assert_allclose(r, ref[f"res/{name}/resid"], rtol=0,
                               atol=1e-11)


@pytest.mark.parametrize("name", STATES)
def test_design_matrix_matches_jacfwd(ref, compiled, name):
    """torch.func.jacfwd through the new components (the TZR row's phase
    inside the differentiated function) against JAX's jacfwd: each column
    within 1e-9 of its own max."""
    cm = compiled(name)
    M = cm.design_matrix(cm.x0()).numpy()
    want = ref[f"res/{name}/design"]
    assert M.shape == want.shape
    assert np.all(np.isfinite(M))
    assert _col_rel(M, want) <= 1e-9


@pytest.mark.parametrize("name", PARREF)
def test_get_model_values_equal_reference(ref, name):
    """The par text parsed by the port gives the reference's internal
    values bit for bit, as hi and lo: golden23's after the TCB -> TDB
    conversion in double-double (epochs through the full time-scale
    hop), golden22's TZR epoch, the pair parameters (WAVEn, IFUNCn)."""
    par = MSP_FULL if name == "msp_full" else _par(name)
    got = {k: v for k, v in reference_values(get_model(par)).items()
           if not isinstance(v, (bool, str))}
    pre = f"parref/{name}/"
    want = {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}
    assert set(got) == set(want)
    for n, v in got.items():
        assert _flat(v) == list(want[n]), n


@pytest.mark.parametrize("stem", GOLDENS)
def test_port_model_on_reference_toas(ref, stem):
    """The port's own model, ``get_model`` of the golden's par text
    (golden23 from its UNITS TCB text), compiled on the reference's TOA
    table (the port reads no .tim file, ROADMAP A11; golden22's TZR row
    comes with it): within 1 ns of the oracle and 1e-11 s of the
    reference's residuals."""
    cm = get_model(_par(stem)).compile(load_state(ref, stem)["bundle"],
                                       device="cpu")
    r = cm.time_residuals(cm.x0()).numpy()
    oracle = np.load(DATADIR / f"{stem}_oracle.npz")
    np.testing.assert_allclose(r, oracle["resid"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(r, ref[f"res/{stem}/resid"], rtol=0,
                               atol=1e-11)


def test_tcb_conversion_moves_golden23():
    """UNITS TCB is converted, not ignored: F0 grows by the factor
    1/(1 - L_B) and PEPOCH moves by the TCB - TDB offset at MJD 55300
    (~ 17 s); the same par read as TDB keeps its text values."""
    par = _par("golden23")
    tcb = get_model(par)
    tdb = get_model(par.replace("UNITS TCB", "UNITS TDB"))
    f_tcb = float(tcb.params["F0"].value)
    f_tdb = float(tdb.params["F0"].value)
    assert f_tcb / f_tdb - 1.0 == pytest.approx(1.550519768e-8, rel=1e-6)
    (d1, s1), (d0, s0) = tcb.params["PEPOCH"].value, tdb.params["PEPOCH"].value
    shift = (d1 - d0) * 86400.0 + float(s1) - float(s0)
    assert -20.0 < shift < -15.0
    assert tcb.top_params["UNITS"].value == "TDB"


@pytest.mark.parametrize("stem", GOLDENS + ["phoff"])
def test_golden_fit_criteria(ref, stem):
    """GLSFitter(device='cpu', fused=False).fit_toas(maxiter=3) on the
    state, at tests/test_golden_regression.py's criteria: chi2 1e-6
    relative, values within 1e-3 sigma, uncertainties 1e-6 relative of
    the oracle.  ``phoff`` is golden20 with PHOFF free: the same chi2,
    values and uncertainties as golden20's oracle, with PHOFF in place of
    the implicit offset (the fitter's covariance has one row a free
    parameter, no offset row)."""
    model, bundle, _ = state_from_numpy(load_state(ref, stem), device="cpu")
    f = GLSFitter(bundle, model, device="cpu", fused=False)
    chi2 = f.fit_toas(maxiter=3)
    oracle = np.load(DATADIR / f"{'golden20' if stem == 'phoff' else stem}"
                     "_oracle.npz")
    assert chi2 == pytest.approx(float(oracle["chi2"]), rel=1e-6)
    for name, val, unc in zip(oracle["names"], oracle["values"],
                              oracle["uncs"]):
        p = model.params[str(name)]
        assert abs(float(p.value) - val) < 1e-3 * unc, name
        assert p.uncertainty == pytest.approx(unc, rel=1e-6), name
    nfree = len(f.cm.free_names)
    assert f.parameter_covariance_matrix.shape == (nfree, nfree)
    if stem == "phoff":
        assert f._noffset == 0 and f.cm.free_names[-1] == "PHOFF"
        assert design_with_offset(f.cm, f.cm.x0()).shape[1] == nfree


def test_phoff_cancels_under_tzr_anchor(ref, compiled):
    """PHOFF enters the data rows' phase and the TZR row's alike, in the
    reference and in the port, so under a TZR anchor its design column is
    zero (without one it is -1/F0 at every TOA)."""
    for name, zero in (("phoff_tzr", True), ("phoff", False)):
        cm = compiled(name)
        i = cm.free_names.index("PHOFF")
        col = cm.design_matrix(cm.x0())[:, i].numpy()
        assert np.array_equal(col, ref[f"res/{name}/design"][:, i]) or (
            _col_rel(col[:, None], ref[f"res/{name}/design"][:, i:i + 1])
            <= 1e-12), name
        assert (np.max(np.abs(col)) == 0.0) == zero, name


def test_tzr_bundle_round_trip(ref, compiled):
    """golden22's TZR row (ingested at gbt by the reference) reaches the
    port's compiled model bit for bit, and the port subtracts its phase:
    without the row the residuals move by far more than 1 ns."""
    cm = compiled("golden22")
    tz = cm.bundle.tzr
    assert tz is not None and tz.ntoa == 1
    for col, got in (("tdb_day", tz.tdb_day), ("tdb_sec_hi", tz.tdb_sec.hi),
                     ("tdb_sec_lo", tz.tdb_sec.lo), ("freq_mhz", tz.freq_mhz),
                     ("ssb_obs_pos_ls", tz.ssb_obs_pos_ls),
                     ("obs_sun_pos_ls", tz.obs_sun_pos_ls)):
        assert np.array_equal(got.numpy(), ref[f"golden22/tzr/bundle/{col}"])
    assert float(torch.max(torch.abs(tz.ssb_obs_pos_ls))) > 100.0
    unanchored = cm.phase(cm.x0()).frac.numpy()
    anchored = cm.phase_residuals(cm.x0()).numpy()
    assert np.max(np.abs(unanchored - anchored)) > 1e-3


def test_noise_basis_column_order(ref, compiled):
    """The stacked basis of the DM and chromatic noise comes in the
    reference's column order (components sorted by class name: chromatic,
    DM, red), and within 1e-12 of its values: (2048, 180) on msp_full."""
    for name in ("golden18", "chrom", "chrom_idx", "msp_full"):
        T, phi = compiled(name).noise_basis(compiled(name).x0())
        assert T.shape == ref[f"res/{name}/T"].shape, name
        assert _rel(T.numpy(), ref[f"res/{name}/T"]) <= 1e-12, name
        assert _rel(phi.numpy(), ref[f"res/{name}/phi"]) <= 1e-12, name
    cm = compiled("msp_full")
    assert [type(c).__name__ for c in cm.model.noise_components
            if c.introduces_correlated_errors] == [
        "PLChromNoise", "PLDMNoise", "PLRedNoise"]
    assert tuple(cm.noise_basis(cm.x0())[0].shape) == (MSP_NTOA, 180)
    # the chromatic index reaches the basis: (1400/f)^3.3 against ^4
    a = ref["res/chrom/T"]
    b = ref["res/chrom_idx/T"]
    assert not np.allclose(a, b)


def _msp_args(compiled):
    cm = compiled("msp_full")
    x0 = cm.x0()
    return cm, (cm.time_residuals(x0, subtract_mean=False),
                design_with_offset(cm, x0),
                torch.square(cm.scaled_sigma(x0)),
                *cm.noise_basis_or_empty(x0))


def test_msp_full_f64_step_matches_reference(ref, compiled):
    """msp_full_par(12) at 2048 TOAs: 169 - 138 = 31 design columns with
    the offset, a (2048, 180) basis; the exact f64 step within 1e-8 of
    its largest component, chi2 1e-9 relative, covariance 1e-8."""
    cm, args = _msp_args(compiled)
    assert args[1].shape == (MSP_NTOA, 1 + 5 + 2 + MSP_NDMX + 2 + 1 + 7 + 1)
    assert "NE_SW" in cm.free_names and "PHOFF" not in cm.free_names
    dx, (covn, _), chi2, nbad = gls_step_woodbury(*args, normalized_cov=True)
    assert int(nbad) == int(ref["step/nbad"]) == 0
    assert _rel(dx.numpy(), ref["step/dx"]) <= 1e-8
    assert abs(float(chi2) - float(ref["step/chi2"])) <= 1e-9 * abs(
        float(chi2))
    assert _rel(covn.numpy(), ref["step/covn"]) <= 1e-8


def test_msp_full_mixed_step_within_gates(compiled, monkeypatch):
    """The mixed step forced on the CPU (the fused kernel's plain version
    and the refined solves, as on the card) against the f64 step at the
    step gates: dx 2e-3, chi2 1e-3, normalized covariance 5e-3."""
    monkeypatch.setenv("PINT_TPU_TORCH_FUSED_INTERIOR", "force")
    monkeypatch.setenv("PINT_TPU_TORCH_SOLVE_IR", "force")
    _, args = _msp_args(compiled)
    got = gls_step_woodbury_mixed(*args, normalized_cov=True)
    want = gls_step_woodbury(*args, normalized_cov=True)
    assert _rel(got[0].numpy(), want[0].numpy()) <= 2e-3
    assert abs(float(got[2]) - float(want[2])) <= 1e-3 * abs(float(want[2]))
    assert _rel(got[1][0].numpy(), want[1][0].numpy()) <= 5e-3


def test_msp_full_fused_refused(ref):
    """GLSFitter(fused=True) raises on the full-width MSP, as the
    reference does: its correlated noise is three bases, not one
    pure-Fourier basis."""
    model, table = make_test_pulsar(MSP_FULL, ntoa=256, device="cpu",
                                    start_mjd=53000.0, end_mjd=57500.0,
                                    iterations=1, orbit=True,
                                    freqs=MSP_FREQS)
    with pytest.raises(PintTpuError, match="pure-Fourier"):
        GLSFitter(table, model, device="cpu", fused=True).fit_toas(maxiter=1)
    assert "pure-Fourier" in ref["__meta__"]["fused_error"]


def test_barycentric_tzr_row_keeps_design_finite():
    """A '@' TZR row built by the port with zero geometry (d = 0 in the
    solar-wind formula) next to data rows with the Sun in place: the
    solar-wind delay of the row is 0, the design matrix finite, the
    NE_SW column nonzero, and every column but the offset's moved by the
    TZR row only by a constant."""
    model, table = make_test_pulsar(MSP_FULL, ntoa=256, device="cpu",
                                    start_mjd=53000.0, end_mjd=57500.0,
                                    iterations=1, orbit=True,
                                    freqs=MSP_FREQS)
    table = dict(table)
    table.pop("tzr")
    cm = model.compile(table, device="cpu")
    tz = cm.bundle.tzr
    assert float(torch.max(torch.abs(tz.obs_sun_pos_ls))) == 0.0
    sw = model.components["SolarWindDispersion"]
    pd = cm._pdict(cm.x0())
    assert float(sw.delay_term(pd, tz, None)[0]) == 0.0
    M = cm.design_matrix(cm.x0())
    assert bool(torch.all(torch.isfinite(M)))
    assert float(torch.max(torch.abs(M[:, cm.free_names.index("NE_SW")]))) > 0


def test_simulated_tzr_row_uses_data_geometry():
    """make_test_pulsar gives a TZR-anchored model its '@' row on the same
    synthetic orbit as its data rows, the Sun at the barycentre, and a
    model without solar wind keeps the Sun's position at zero."""
    model, table = make_test_pulsar(MSP_FULL, ntoa=64, device="cpu",
                                    start_mjd=53000.0, end_mjd=57500.0,
                                    iterations=1, orbit=True,
                                    freqs=MSP_FREQS)
    tzr = table["tzr"]
    assert np.array_equal(tzr["obs_sun_pos_ls"], -tzr["ssb_obs_pos_ls"])
    assert abs(np.linalg.norm(tzr["ssb_obs_pos_ls"]) - 499.00478) < 1e-3
    assert np.array_equal(table["obs_sun_pos_ls"], -table["ssb_obs_pos_ls"])
    _, plain = make_test_pulsar(_par("golden21"), ntoa=16, device="cpu",
                                orbit=True)
    assert "obs_sun_pos_ls" not in plain and "tzr" not in plain


@pytest.mark.parametrize("stem", [f"golden{i}" for i in range(1, 24)
                                  if i != 4])
def test_get_model_accepts_every_narrowband_line(stem):
    """Every par line of goldens 1-3 and 5-23 is ported, golden17's
    wideband DMJUMP, DMEFAC and DMEQUAD included."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        model = get_model(_par(stem))
        assert model.unrecognized == {}
        if stem == "golden17":
            assert {"DMJump", "ScaleDmError"} <= set(model.components)


#: the card's sets: par texts simulated by the port (the card has no JAX)
CARD_SETS = {"golden7": _par("golden7"), "golden19": _par("golden19"),
             "golden20": _par("golden20"), "nesw1": SYNTH["nesw1"][0],
             "msp_full": MSP_FULL}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_SETS))
def test_components_on_card_equal_cpu(name):
    """The new components on the card against the CPU on a 512-TOA
    pulsar simulated by the port (orbit, Sun and TZR row in place):
    residuals within 1e-11 s, design columns within 1e-9 of their max."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    model, table = make_test_pulsar(CARD_SETS[name], ntoa=512, device="cpu",
                                    start_mjd=53000.0, end_mjd=57500.0,
                                    iterations=1, orbit=True,
                                    freqs=MSP_FREQS)
    out = {}
    for dev in ("cpu", "cuda"):
        cm = model.compile(table, device=dev)
        out[dev] = (cm.time_residuals(cm.x0()).cpu().numpy(),
                    cm.design_matrix(cm.x0()).cpu().numpy())
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0,
                               atol=1e-11)
    assert _col_rel(out["cuda"][1], out["cpu"][1]) <= 1e-9
