"""Parity of the port's binary-pulsar slice with the JAX package.

The ten binary models, DMX, JUMP, FD and ecliptic astrometry, on eleven
golden sets that need only ported components (golden14 and golden15
ingested through the committed clock/EOP/ephemeris data; golden3, with
DM1/DM2, F2 and ECORR, has no binary), on BT and DDK
par texts cut from golden7 and golden6 (without their glitch, wave,
ifunc and solar-wind lines), and on the binary MSP of ``chip_smoke.py``
(``pint_tpu_torch.simulation.msp_par``) at 2048 TOAs with 12 DMX ranges:
the copy simulated as the reference simulates it, and the copy the port
simulates with the orbit inside the phases, on which the f64 step's
spread under rounding is measured (ROADMAP C, R4).
The reference runs once per module in a subprocess
(tests/torch_reference.py) and its state is carried across with
``pint_tpu_torch.convert.state_from_numpy``, so both packages compute on
byte-identical inputs (the port's own ingest of the same tim files is
held to the reference's in tests/test_torch_ingest.py).  Tolerances are stated per test.
"""

import math
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import load_state, run_reference  # noqa: E402

from pint_tpu_torch.constants import C  # noqa: E402
from pint_tpu_torch.convert import state_from_numpy  # noqa: E402
from pint_tpu_torch.fitting.base import design_with_offset  # noqa: E402
from pint_tpu_torch.fitting.spread import (  # noqa: E402
    f64_step,
    ordering_gaps,
    rounding_gaps,
)
from pint_tpu_torch.fitting.gls import (  # noqa: E402
    GLSFitter,
    gls_step_woodbury,
    gls_step_woodbury_fourier,
    gls_step_woodbury_mixed,
)
from pint_tpu_torch.models.builder import get_model  # noqa: E402
from pint_tpu_torch.models.component import DEFAULT_ORDER  # noqa: E402
from pint_tpu_torch.models.timing_model import (  # noqa: E402
    reference_values,
)
from pint_tpu_torch.models.astrometry import sincos_about  # noqa: E402
from pint_tpu_torch.simulation import (  # noqa: E402
    MSP_FREQS,
    make_test_pulsar,
    msp_par,
    orbit_pos_m,
)
from pint_tpu_torch.timebase.hostdd import HostDD  # noqa: E402

DATADIR = Path(__file__).parent / "datafile"
GOLDENS = ["golden1", "golden2", "golden3", "golden5", "golden8",
           "golden9", "golden10", "golden11", "golden12", "golden14",
           "golden15"]
#: which binary model each golden drives
BINARY_OF = {"golden1": "ELL1", "golden2": "DD", "golden5": "ELL1H",
             "golden8": "DDGR", "golden9": "ELL1K", "golden10": "DDS",
             "golden11": "DDH", "golden12": "BT_PIECEWISE",
             "golden14": "ELL1", "golden15": "DD"}
#: the synthetic sets: BT from golden7 without glitch, wave and ifunc;
#: DDK from golden6 without NE_SW
SYNTH = {"bt": ("golden7", ("GL", "WAVE", "SIFUNC", "IFUNC")),
         "ddk": ("golden6", ("NE_SW",))}
STATES = GOLDENS + list(SYNTH)
FITS = ["golden1", "golden2", "golden3", "golden14"]
MSP_NDMX = 12
MSP_NTOA = 2048
MSP_PAR = msp_par(MSP_NDMX, seed=0)
#: chip_smoke.py's in-phase copy (its ``sigma_gap`` phase): the orbit is
#: inside the simulated phases
IN_PHASE = dict(start_mjd=53000.0, end_mjd=57500.0, seed=0, iterations=1,
                orbit=True, freqs=MSP_FREQS, orbit_in_phase=True)


def in_phase_copy():
    """(model, table) of the in-phase 2048-TOA MSP copy, simulated by the
    port on the CPU."""
    return make_test_pulsar(MSP_PAR, ntoa=MSP_NTOA, device="cpu", **IN_PHASE)


def _synth_par(stem, drop):
    lines = (DATADIR / f"{stem}.par").read_text().splitlines()
    return "\n".join(ln for ln in lines
                     if not ln.split() or not ln.split()[0].startswith(drop))


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

def build(par, tim, ingest):
    env = golden_ingest_env() if ingest else contextlib.nullcontext()
    with warnings.catch_warnings(), env:
        warnings.simplefilter("ignore")
        model, toas = get_model_and_toas(par, tim)
        return model.compile(toas)

def record(name, cm):
    export_state(cm, name)
    x0 = cm.x0()
    OUT[f"res/{{name}}/resid"] = np.asarray(cm.time_residuals(x0))
    OUT[f"res/{{name}}/design"] = np.asarray(cm.design_matrix(x0))

for stem in {GOLDENS!r}:
    record(stem, build(f"tests/datafile/{{stem}}.par",
                       f"tests/datafile/{{stem}}.tim",
                       stem in ("golden14", "golden15")))
for name, (par, stem) in {{"bt": ({_synth_par(*SYNTH["bt"])!r}, "golden7"),
                          "ddk": ({_synth_par(*SYNTH["ddk"])!r}, "golden6")
                          }}.items():
    record(name, build(par, f"tests/datafile/{{stem}}.tim", False))

# the binary MSP, simulated and given the synthetic 1-AU orbit as bench.py
model, toas = make_test_pulsar({MSP_PAR!r}, ntoa={MSP_NTOA}, start_mjd=53000.0,
                               end_mjd=57500.0, seed=0, iterations=1,
                               freqs={MSP_FREQS!r})
ph = 2 * np.pi * (toas.t.mjd_int + toas.t.sec.to_float() / SECS_PER_DAY
                  - 53000.0) / 365.25
toas.ssb_obs_pos = np.stack([AU * np.cos(ph), AU * np.sin(ph),
                             np.zeros_like(ph)], axis=-1)
cm = model.compile(toas)
record("msp", cm)
x0 = cm.x0()
r = cm.time_residuals(x0, subtract_mean=False)
M = design_with_offset(cm, x0)
Nd = jnp.square(cm.scaled_sigma(x0))
import pint_tpu.ops.ffgram as rffgram
gram32 = rffgram.gram32


def gram_f64_sums(A, w):
    # the port's G_XX (fitting/gls.py::_white_gram): gram32's f32 values,
    # their products summed in f64
    Y = (A * jnp.sqrt(w)[:, None]).astype(jnp.float32).astype(jnp.float64)
    return Y.T @ Y


for step, args in (("f64", (*cm.noise_basis_or_empty(x0),)),
                   ("fourier", (*cm.noise_fourier_spec(x0),)),
                   ("fourier64", (*cm.noise_fourier_spec(x0),))):
    fn = (rgls.gls_step_woodbury if step == "f64"
          else rgls.gls_step_woodbury_fourier)
    rffgram.gram32 = gram_f64_sums if step == "fourier64" else gram32
    dx, (covn, _), chi2, _ = fn(r, M, Nd, *args, normalized_cov=True)
    OUT[f"step/{{step}}/dx"] = np.asarray(dx)
    OUT[f"step/{{step}}/covn"] = np.asarray(covn)
    OUT[f"step/{{step}}/chi2"] = np.asarray(chi2)
rffgram.gram32 = gram32

# the port's in-phase copy, carried in: the reference's f64 step on it
from pint_tpu.timebase.times import TimeArray
from pint_tpu.toas.ingest import ingest_barycentric
from pint_tpu.toas.toas import TOAs
r4 = np.load(os.environ["R4_TABLE"])
t4 = TOAs(TimeArray(r4["day"].astype(np.int64), HostDD(r4["hi"], r4["lo"]),
                    "tdb"), r4["freq"], r4["err"], ["@"] * len(r4["freq"]),
          [{{"f": str(f)}} for f in r4["flags"]])
ingest_barycentric(t4)
t4.ssb_obs_pos = r4["pos_m"]
c4 = get_model({MSP_PAR!r}).compile(t4)
x4 = c4.x0()
r_4 = c4.time_residuals(x4, subtract_mean=False)
dx, (covn, norm), _, _ = rgls.gls_step_woodbury(
    r_4, design_with_offset(c4, x4), jnp.square(c4.scaled_sigma(x4)),
    *c4.noise_basis_or_empty(x4), normalized_cov=True)
OUT["r4/resid"] = np.asarray(r_4)
OUT["r4/dx"] = np.asarray(dx)
OUT["r4/sig"] = np.asarray(jnp.sqrt(jnp.diagonal(covn)) / norm)

ref = reference_values(get_model({MSP_PAR!r}))
for n, v in ref.items():
    if isinstance(v, HostDD):
        OUT[f"parref/{{n}}"] = np.array([v.hi, v.lo], float)
    elif isinstance(v, tuple):
        OUT[f"parref/{{n}}"] = np.array([v[0], v[1].hi, v[1].lo], float)
    elif not isinstance(v, (bool, str)):
        OUT[f"parref/{{n}}"] = np.array([v], float)
""")


@pytest.fixture(scope="module")
def in_phase():
    return in_phase_copy()


@pytest.fixture(scope="module")
def ref(tmp_path_factory, in_phase):
    d = tmp_path_factory.mktemp("ref")
    _, t = in_phase
    sec = HostDD(t["tdb_sec_hi"], t["tdb_sec_lo"])
    pos_m = orbit_pos_m(t["tdb_day"], sec, IN_PHASE["start_mjd"])
    # the reference divides metres by C as the port's simulation did
    assert np.array_equal(pos_m / C, t["ssb_obs_pos_ls"])
    np.savez(d / "r4.npz", day=t["tdb_day"], hi=t["tdb_sec_hi"],
             lo=t["tdb_sec_lo"], freq=t["freq_mhz"], err=t["error_us"],
             flags=np.array([f["f"] for f in t["flags"]]), pos_m=pos_m)
    return run_reference(_SCRIPT, d / "bin.npz", timeout=900,
                         env={"R4_TABLE": str(d / "r4.npz")})


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


@pytest.mark.parametrize("stem", GOLDENS)
def test_golden_residuals_match_oracle(compiled, stem):
    """The port's residuals on each golden's state against its committed
    oracle: < 1 ns, the golden regression bar."""
    cm = compiled(stem)
    binaries = [c for n, c in cm.model.components.items()
                if n.startswith("Binary")]
    assert [type(c).binary_model_name for c in binaries] == (
        [BINARY_OF[stem]] if stem in BINARY_OF else [])
    oracle = np.load(DATADIR / f"{stem}_oracle.npz")
    r = cm.time_residuals(cm.x0()).numpy()
    np.testing.assert_allclose(r, oracle["resid"], rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", STATES + ["msp"])
def test_residuals_match_reference(ref, compiled, name):
    """Residuals on the same state within 1e-11 s of the reference's (the
    same double-double orbit counting and f64 orbital kernels; the margin
    covers the transcendental libraries' last-ulp differences)."""
    cm = compiled(name)
    r = cm.time_residuals(cm.x0()).numpy()
    np.testing.assert_allclose(r, ref[f"res/{name}/resid"], rtol=0,
                               atol=1e-11)


@pytest.mark.parametrize("name", STATES + ["msp"])
def test_design_matrix_matches_jacfwd(ref, compiled, name):
    """torch.func.jacfwd through the binary kernels against JAX's jacfwd:
    each column within 1e-9 of its own max."""
    cm = compiled(name)
    M = cm.design_matrix(cm.x0()).numpy()
    want = ref[f"res/{name}/design"]
    assert M.shape == want.shape
    assert _col_rel(M, want) <= 1e-9


@pytest.mark.parametrize("stem", FITS)
def test_golden_fit_criteria(ref, stem):
    """GLSFitter(device='cpu', fused=False).fit_toas(maxiter=3) on the
    golden's state, at tests/test_golden_regression.py's criteria: chi2
    1e-6 relative, values within 1e-3 sigma, uncertainties 1e-6
    relative of the oracle."""
    model, bundle, _ = state_from_numpy(load_state(ref, stem), device="cpu")
    f = GLSFitter(bundle, model, device="cpu", fused=False)
    chi2 = f.fit_toas(maxiter=3)
    oracle = np.load(DATADIR / f"{stem}_oracle.npz")
    assert chi2 == pytest.approx(float(oracle["chi2"]), rel=1e-6)
    for name, val, unc in zip(oracle["names"], oracle["values"],
                              oracle["uncs"]):
        p = model.params[str(name)]
        assert abs(float(p.value) - val) < 1e-3 * unc, name
        assert p.uncertainty == pytest.approx(unc, rel=1e-6), name


def _msp_step_args(compiled):
    cm = compiled("msp")
    x0 = cm.x0()
    return cm, (cm.time_residuals(x0, subtract_mean=False),
                design_with_offset(cm, x0), torch.square(cm.scaled_sigma(x0)))


def _step(step, *args):
    dx, (covn, _), chi2, _ = step(*args, normalized_cov=True)
    return dx.numpy(), covn.numpy(), float(chi2)


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_msp_shapes(compiled):
    """The small MSP has the slice's composition: 12 DMX ranges, the
    offset and 29 free parameters, a 60-column basis."""
    cm, (r, M, _) = _msp_step_args(compiled)
    T, _ = cm.noise_basis_or_empty(cm.x0())
    assert M.shape == (MSP_NTOA, 5 + 2 + MSP_NDMX + 2 + 1 + 7 + 1)
    assert T.shape == (MSP_NTOA, 60)


def test_msp_f64_step_matches_reference(ref, compiled):
    """The exact f64 step on the small MSP: dx within 1e-8 of its largest
    component, chi2 1e-9 relative, covariance 1e-8."""
    cm, args = _msp_step_args(compiled)
    dx, covn, chi2 = _step(gls_step_woodbury, *args,
                           *cm.noise_basis_or_empty(cm.x0()))
    assert _rel(dx, ref["step/f64/dx"]) <= 1e-8
    assert abs(chi2 - float(ref["step/f64/chi2"])) <= 1e-9 * abs(chi2)
    assert _rel(covn, ref["step/f64/covn"]) <= 1e-8


def test_msp_mixed_step_within_gates(compiled, monkeypatch):
    """The mixed step forced on the CPU (the fused kernel's plain version
    and the refined solves, as on the card) against the f64 step at the
    step gates: dx 2e-3, chi2 1e-3, normalized covariance 5e-3."""
    monkeypatch.setenv("PINT_TPU_TORCH_FUSED_INTERIOR", "force")
    monkeypatch.setenv("PINT_TPU_TORCH_SOLVE_IR", "force")
    cm, args = _msp_step_args(compiled)
    basis = cm.noise_basis_or_empty(cm.x0())
    got = _step(gls_step_woodbury_mixed, *args, *basis)
    want = _step(gls_step_woodbury, *args, *basis)
    assert _rel(got[0], want[0]) <= 2e-3
    assert abs(got[2] - want[2]) <= 1e-3 * abs(want[2])
    assert _rel(got[1], want[1]) <= 5e-3


def test_msp_fourier_step_matches_reference(ref, compiled):
    """The streaming-basis step (GLSFitter(fused=True)'s) on the small
    MSP against the reference's, at tests/test_torch_fourier.py's
    tolerances (dx 1e-3 of the largest component, chi2 1e-6 relative,
    normalized covariance 1e-3), with the reference's white Gram G_XX
    summed in f64 as the port sums it (ROADMAP C: the port's one
    deliberate departure).  With its own f32 sums (gram32) the
    reference's step is itself 1.8e-6 off its f64 step's chi2 and 3.2e-3
    off its covariance on this pulsar, the port's 1.1e-8 and 8.5e-6, so
    against that step the port is held to the step gates (2e-3, 1e-3,
    5e-3)."""
    cm, args = _msp_step_args(compiled)
    dx, covn, chi2 = _step(gls_step_woodbury_fourier, *args,
                           *cm.noise_fourier_spec(cm.x0()))
    for key, gates in (("fourier64", (1e-3, 1e-6, 1e-3)),
                       ("fourier", (2e-3, 1e-3, 5e-3))):
        assert _rel(dx, ref[f"step/{key}/dx"]) <= gates[0], key
        assert abs(chi2 - float(ref[f"step/{key}/chi2"])) <= (
            gates[1] * abs(chi2)), key
        assert _rel(covn, ref[f"step/{key}/covn"]) <= gates[2], key


def test_msp_par_reference_values_exact(ref):
    """The MSP par text parsed by the port gives the reference's internal
    values bit for bit (ecliptic angles, DMX ranges, FD, JUMP, the ELL1
    orbit with PB and F0 in double-double, epochs)."""
    got = reference_values(get_model(MSP_PAR))
    want = {k.split("/", 1)[1]: v for k, v in ref.items()
            if k.startswith("parref/")}
    numeric = {k: v for k, v in got.items() if not isinstance(v, (bool, str))}
    assert set(numeric) == set(want)
    for n, v in numeric.items():
        if isinstance(v, HostDD):
            flat = [float(v.hi), float(v.lo)]
        elif isinstance(v, tuple):
            flat = [float(v[0]), float(v[1].hi), float(v[1].lo)]
        else:
            flat = [float(v)]
        assert flat == list(want[n]), n


def test_component_order_and_selection():
    """The full DEFAULT_ORDER: the binary sees astrometry, Shapiro, DM,
    DMX and FD before it, and the phase jump comes after spindown; the
    builder picks the binary model from the BINARY line."""
    model = get_model(MSP_PAR)
    delays = [type(c).__name__ for c in model.delay_components]
    assert delays == ["AstrometryEcliptic", "SolarSystemShapiro",
                      "DispersionDM", "DispersionDMX", "FD", "BinaryELL1"]
    assert [type(c).__name__ for c in model.phase_components] == [
        "Spindown", "PhaseJump"]
    assert DEFAULT_ORDER.index("pulsar_system") > DEFAULT_ORDER.index(
        "frequency_dependent")
    for kind in ("BT", "DD", "DDS", "DDH", "DDGR", "ELL1", "ELL1H",
                 "ELL1K"):
        par = MSP_PAR.replace("BINARY ELL1", f"BINARY {kind}")
        names = [type(c).__name__ for c in _binary_only(par, kind)]
        assert len(names) == 1 and names[0].lower().endswith(
            kind.lower().replace("_", ""))


def test_tempo_unit_scale():
    """PBDOT-like par values past 1e-7 are in units of 1e-12, with their
    uncertainty (the reference's floatParameter unit_scale); smaller ones
    are taken as they are."""
    m = get_model(MSP_PAR + "PBDOT 2.5 1 0.3\nXPBDOT 3e-13\n")
    b = m.components["BinaryELL1"]
    assert b.params["PBDOT"].value == 2.5 * 1e-12
    assert b.params["PBDOT"].uncertainty == 0.3 * 1e-12
    assert b.params["XPBDOT"].value == 3e-13


def _binary_only(par, kind):
    """The binary component the builder picks for ``kind`` (its
    parameters need not validate)."""
    from pint_tpu_torch.models.builder import ModelBuilder, parse_parfile
    from pint_tpu_torch.models.pulsar_binary import PulsarBinary

    return [c for c in ModelBuilder().choose_components(parse_parfile(par))
            if isinstance(c, PulsarBinary)]


def test_dmx_range_matrix_matches_per_range_masks(ref, compiled):
    """The port's one (n, ranges) DMX matrix holds the reference's
    per-range masks as its columns, in range order, and its DM is the
    reference's sum of masked terms bit for bit (one range a TOA)."""
    cm = compiled("msp")
    M = cm.bundle.masks["dispersion_dmx:M"].numpy()
    cols = [ref[f"msp/masks/DMX_{i:04d}"] for i in range(1, MSP_NDMX + 1)]
    assert np.array_equal(M, np.stack(cols, axis=1))
    assert np.all(M.sum(axis=1) == 1.0)
    dmx = cm.model.components["DispersionDMX"]
    pd = cm._pdict(cm.x0())
    loop = torch.zeros(M.shape[0], dtype=torch.float64)
    for i in dmx.dmx_indices:
        loop = loop + pd[f"DMX_{i:04d}"] * torch.as_tensor(
            ref[f"msp/masks/DMX_{i:04d}"])
    assert torch.equal(dmx.dm_value(pd, cm.bundle), loop)


# -- R4: the f64 step's spread under rounding, on the in-phase copy ---------
def test_r4_step_spread_under_ordering_and_rounding(in_phase):
    """On the in-phase MSP copy the f64 step moves by 1e-13 to 5e-12 sigma
    when only the order of its sums changes (eight seeded permutations of
    the TOAs: at most 1e-10), but by 5e-8 to 1e-7 sigma when each residual
    moves by one ulp of its ~400 s delay (between 1e-8 and 1e-6): a
    last-bit difference in one delay term, not the summation order, is
    what can part two devices' steps by the 1.2e-7 sigma of ROADMAP C R4."""
    model, table = in_phase
    order = ordering_gaps(model, table, "cpu")
    rounding = rounding_gaps(model, table, "cpu")
    assert max(order) <= 1e-10, order
    assert 1e-8 <= min(rounding) and max(rounding) <= 1e-6, rounding


def test_r4_port_step_matches_reference_on_in_phase_copy(ref, in_phase):
    """The port's f64 step on its in-phase copy against the reference's on
    the same TOAs: residuals within 1e-11 s, and the step within 1e-5
    sigma, that residual bound in units of the copy's 1 us TOA errors.
    (The packages' transcendentals round differently: the residuals read
    1.7e-13 s apart, the step 7.8e-7 sigma on ELAT.)"""
    model, table = in_phase
    cm = model.compile(table, device="cpu")
    r = cm.time_residuals(cm.x0(), subtract_mean=False).numpy()
    np.testing.assert_allclose(r, ref["r4/resid"], rtol=0, atol=1e-11)
    dx, sig, _ = f64_step(cm)
    gap = np.abs(dx.numpy() - ref["r4/dx"]) / sig.numpy()
    assert float(gap.max()) <= 1e-5


@pytest.mark.parametrize("ref_angle", [4.9604159750563515,
                                       -0.26451337459883995, 1.2097965,
                                       3.1])
def test_sincos_about_is_sin_and_cos(ref_angle):
    """The astrometry's sin and cos about a reference angle (R4's repair)
    within 1 ulp of torch.sin and torch.cos, for offsets up to 1e-2 rad
    (proper motion over decades, fit steps), and exactly sin and cos of
    the reference at zero offset."""
    rng = np.random.default_rng(0)
    for span in (1e-8, 1e-5, 1e-2):
        a = torch.as_tensor(ref_angle + rng.uniform(-span, span, 20000))
        s, c = sincos_about(a, ref_angle)
        for got, want in ((s, torch.sin(a)), (c, torch.cos(a))):
            ulp = torch.as_tensor(np.spacing(np.abs(want.numpy())))
            assert float(torch.max(torch.abs(got - want) / ulp)) <= 1.0
    s0, c0 = sincos_about(torch.tensor(ref_angle, dtype=torch.float64),
                          ref_angle)
    assert float(s0) == math.sin(ref_angle)
    assert float(c0) == math.cos(ref_angle)


@pytest.mark.gpu
def test_astrometry_delay_on_card_equals_cpu(in_phase):
    """R4's repair on the card: the ecliptic astrometry delay of the
    in-phase copy equals the CPU's bit for bit at all but a few TOAs (a
    result within a few ulps of the small terms of a rounding boundary
    may still round the other way) and within 1 ulp at every TOA."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    model, table = in_phase
    terms = {}
    for dev in ("cpu", "cuda"):
        cm = model.compile(table, device=dev)
        pd = cm._pdict(cm.x0())
        comp = model.components["AstrometryEcliptic"]
        terms[dev] = comp.delay_term(pd, cm.bundle, None).cpu()
    diff = torch.abs(terms["cuda"] - terms["cpu"])
    ulp = torch.as_tensor(np.spacing(np.abs(terms["cpu"].numpy())))
    assert int(torch.count_nonzero(diff)) <= 2
    assert float(torch.max(diff / ulp)) <= 1.0
