"""Parity of the port's wideband slice with the JAX package.

DMJUMP (``DMJump``), DMEFAC/DMEQUAD (``ScaleDmError``), the DM
interfaces of ``CompiledModel`` (``dm_model``, ``dm_residuals``,
``scaled_dm_sigma``, with the solar wind's share), and the wideband
fitters (``WidebandTOAFitter``, ``WidebandDownhillFitter``) on the two
wideband goldens, golden4 (DMX, ELL1) and golden17 (DMJUMP, DMEFAC,
DMEQUAD, ECORR), and on golden6's TOAs given DM measurements (its
NE_SW).  The reference runs once per module in a subprocess
(tests/torch_reference.py) and its state, DM measurements included, is
carried across with ``pint_tpu_torch.convert.state_from_numpy``, so both
packages compute on byte-identical inputs.  Tolerances are stated per
test.
"""

import math
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
from pint_tpu_torch.exceptions import (  # noqa: E402
    PintTpuError,
    TimingModelError,
)
from pint_tpu_torch.fitting import (  # noqa: E402
    WidebandDownhillFitter,
    WidebandResiduals,
    WidebandTOAFitter,
    auto_fitter,
)
from pint_tpu_torch.fitting.base import DegeneracyWarning  # noqa: E402
from pint_tpu_torch.models.builder import get_model  # noqa: E402
from pint_tpu_torch.ops import fused_gram  # noqa: E402
from pint_tpu_torch.simulation import (  # noqa: E402
    MSP_FREQS,
    make_test_pulsar,
    msp_wideband_par,
)
from pint_tpu_torch.toas.bundle import (  # noqa: E402
    get_dm_measurements,
    is_wideband,
)

DATADIR = Path(__file__).parent / "datafile"
GOLDENS = ["golden4", "golden17"]
#: golden6 (NE_SW, DMX) with seeded DM measurements on its TOAs
SW_SEED = 11

_SCRIPT = textwrap.dedent(f"""
import warnings
import jax.numpy as jnp
from pint_tpu.fitting.gls import gls_step_full_cov
from pint_tpu.fitting.wideband import WidebandTOAFitter
from pint_tpu.models.builder import get_model, get_model_and_toas

def load(stem):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return get_model_and_toas(f"tests/datafile/{{stem}}.par",
                                  f"tests/datafile/{{stem}}.tim")

def record(name, model, toas):
    cm = model.compile(toas)
    export_state(cm, name)
    x0 = cm.x0()
    OUT[f"res/{{name}}/resid"] = np.asarray(cm.time_residuals(x0))
    OUT[f"res/{{name}}/dm_model"] = np.asarray(cm.dm_model(x0))
    OUT[f"res/{{name}}/dm_resid"] = np.asarray(cm.dm_residuals(x0))
    OUT[f"res/{{name}}/dm_sigma"] = np.asarray(cm.scaled_dm_sigma(x0))
    return cm

for stem in {GOLDENS!r}:
    model, toas = load(stem)
    record(stem, model, toas)
    # one step of each mode from the par values, covariance normalized
    for mode in ("f64", "mixed"):
        f = WidebandTOAFitter(toas, model,
                              fused=False if mode == "f64" else "mixed")
        dx, (covn, norm), chi2, _ = f._make_step(mode)(f.cm.x0())
        OUT[f"step/{{stem}}/{{mode}}/dx"] = np.asarray(dx)
        OUT[f"step/{{stem}}/{{mode}}/covn"] = np.asarray(covn)
        OUT[f"step/{{stem}}/{{mode}}/chi2"] = np.asarray(chi2)

# golden6's TOAs with DM measurements: its solar wind counts toward DM
model, toas = load("golden6")
rng = np.random.default_rng({SW_SEED})
for f in toas.flags:
    f["pp_dm"] = repr(float(15.0 + rng.normal(0.0, 2e-4)))
    f["pp_dme"] = "2e-4"
record("sw", model, toas)

# the f64 dense step on the port's stacked 40-TOA wideband system
inp = np.load(os.environ["WB_DENSE_INPUTS"])
dx, (covn, _), chi2, _ = gls_step_full_cov(
    *(jnp.asarray(inp[str(i)]) for i in range(5)), method="f64",
    normalized_cov=True)
OUT["dense/dx"] = np.asarray(dx)
OUT["dense/covn"] = np.asarray(covn)
OUT["dense/chi2"] = np.asarray(chi2)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("wideband")
    model, toas = _wb_table(n=40)
    f = WidebandTOAFitter(toas, model, device="cpu")
    x0 = f.cm.x0()
    args = (*f._step_inputs(x0), *f._step_noise(x0))
    np.savez(d / "dense.npz", **{str(i): a.numpy()
                                 for i, a in enumerate(args)})
    return run_reference(_SCRIPT, d / "wb.npz", timeout=900,
                         env={"WB_DENSE_INPUTS": str(d / "dense.npz")})


def _state(ref, name):
    model, bundle, _ = state_from_numpy(load_state(ref, name), device="cpu")
    return model, bundle


@pytest.fixture(scope="module")
def compiled(ref):
    cache = {}

    def get(name):
        if name not in cache:
            model, bundle = _state(ref, name)
            cache[name] = model.compile(bundle)
        return cache[name]

    return get


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("stem", GOLDENS)
def test_golden_residuals_match_oracle(compiled, stem):
    """Time residuals on each wideband golden's state within 1 ns of its
    committed oracle."""
    cm = compiled(stem)
    oracle = np.load(DATADIR / f"{stem}_oracle.npz")
    r = cm.time_residuals(cm.x0()).numpy()
    np.testing.assert_allclose(r, oracle["resid"], rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", GOLDENS + ["sw"])
def test_dm_residuals_match_reference(ref, compiled, name):
    """DM residuals and the model DM within 1e-12 pc cm^-3 of the
    reference's; the DMEFAC/DMEQUAD-scaled DM sigma equal to it (the
    same f64 operations in the same order); time residuals within
    1e-11 s."""
    cm = compiled(name)
    x0 = cm.x0()
    np.testing.assert_allclose(cm.dm_model(x0).numpy(),
                               ref[f"res/{name}/dm_model"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(cm.dm_residuals(x0).numpy(),
                               ref[f"res/{name}/dm_resid"], rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(cm.scaled_dm_sigma(x0).numpy(),
                                  ref[f"res/{name}/dm_sigma"])
    np.testing.assert_allclose(cm.time_residuals(x0).numpy(),
                               ref[f"res/{name}/resid"], rtol=0,
                               atol=1e-11)


def test_solar_wind_counts_toward_dm(compiled):
    """NE_SW's DM share (SolarWindDispersion.dm_value) enters the model
    DM as the reference's does: without it dm_model would miss its
    ~1e-4-1e-2 pc cm^-3 (test_dm_residuals_match_reference holds the
    sum to 1e-12)."""
    cm = compiled("sw")
    sw = cm.model.components["SolarWindDispersion"]
    pd = cm._pdict(cm.x0())
    share = sw.dm_value(pd, cm.bundle)
    assert float(share.abs().max()) > 1e-6
    assert torch.equal(share, sw.solar_wind_dm(pd, cm.bundle))


def test_golden17_components_and_scaling(compiled):
    """golden17 builds DMJump and ScaleDmError; DMEFAC scales the L-wide
    DM errors and DMEQUAD adds in quadrature on S-wide; the DMJUMP moves
    only the S-wide model DM and no delay."""
    cm = compiled("golden17")
    comps = cm.model.components
    assert {"DMJump", "ScaleDmError"} <= set(comps)
    x0 = cm.x0()
    b = cm.bundle
    sig = cm.scaled_dm_sigma(x0)
    lw = b.masks["DMEFAC1"].bool()
    sw = b.masks["DMEQUAD1"].bool()
    torch.testing.assert_close(sig[lw], 1.25 * b.dm_err[lw], rtol=1e-15,
                               atol=0)
    torch.testing.assert_close(
        sig[sw], torch.sqrt(b.dm_err[sw] ** 2 + 1.5e-4 ** 2), rtol=1e-15,
        atol=0)
    pd = cm._pdict(x0)
    jump = comps["DMJump"]
    assert torch.all(jump.delay_term(pd, b, None) == 0)
    off = jump.dm_offset(pd, b)
    mask = b.masks["DMJUMP1"].bool()
    assert torch.all(off[~mask] == 0)
    torch.testing.assert_close(off[mask], torch.full_like(off[mask],
                                                          -0.00032))


def test_dm_residuals_need_dm_measurements():
    """A narrowband table has no DM residuals, as in the reference."""
    model, toas = make_test_pulsar(
        "PSR X\nF0 100.0 1\nPEPOCH 55000\nDM 10.0 1\n", ntoa=16,
        device="cpu")
    cm = model.compile(toas, device="cpu")
    assert not is_wideband(toas) and cm.bundle.dm_meas is None
    with pytest.raises(TimingModelError, match="pp_dm"):
        cm.dm_residuals(cm.x0())


@pytest.mark.parametrize("stem", GOLDENS)
def test_golden_fit_criteria(ref, stem):
    """WidebandTOAFitter(device='cpu').fit_toas(maxiter=3) on the
    golden's state, at tests/test_golden_regression.py's criteria: chi2
    1e-6 relative, values within 1e-3 sigma, uncertainties 1e-6
    relative of the oracle."""
    model, bundle = _state(ref, stem)
    f = WidebandTOAFitter(bundle, model, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DegeneracyWarning)
        chi2 = f.fit_toas(maxiter=3)
    oracle = np.load(DATADIR / f"{stem}_oracle.npz")
    assert chi2 == pytest.approx(float(oracle["chi2"]), rel=1e-6)
    for name, val, unc in zip(oracle["names"], oracle["values"],
                              oracle["uncs"]):
        p = model.params[str(name)]
        v = p.value
        v = float(v.to_float()) if hasattr(v, "to_float") else float(v)
        assert abs(v - val) < 1e-3 * unc, name
        assert p.uncertainty == pytest.approx(unc, rel=1e-6), name
    assert isinstance(f.resids, WidebandResiduals)
    assert f.resids.chi2 == pytest.approx(
        f.resids.toa_chi2 + f.resids.dm_chi2)


@pytest.mark.parametrize("stem", GOLDENS)
def test_downhill_lands_on_toa_fitter(ref, stem):
    """WidebandDownhillFitter converges to WidebandTOAFitter's values
    (the reference's test_wideband_downhill_matches_plain): chi2 1e-6
    relative, every value within 1e-6 of its uncertainty."""
    m1, b1 = _state(ref, stem)
    m2, b2 = _state(ref, stem)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DegeneracyWarning)
        c1 = WidebandTOAFitter(b1, m1, device="cpu").fit_toas(maxiter=4)
        f2 = WidebandDownhillFitter(b2, m2, device="cpu")
        c2 = f2.fit_toas()
    assert f2.converged and f2.guard_report.rung == "native"
    assert c2 == pytest.approx(c1, rel=1e-6)
    for n in f2.cm.free_names:
        v1, v2 = m1.params[n].value, m2.params[n].value
        if hasattr(v1, "to_float"):
            v1, v2 = float(v1.to_float()), float(v2.to_float())
        assert abs(float(v1) - float(v2)) <= 1e-6 * m1.params[
            n].uncertainty, n


def _step(f, mode):
    x0 = f.cm.x0()
    xn, (covn, _), chi2, _ = f._gn_step(x0, mode)
    return xn.numpy(), covn.numpy(), float(chi2)


@pytest.mark.parametrize("stem", GOLDENS)
def test_f64_step_matches_reference(ref, stem):
    """The wideband f64 step over the stacked rows from the par values:
    dx within 1e-8 of its largest component, chi2 1e-9 relative, the
    normalized covariance 1e-8."""
    model, bundle = _state(ref, stem)
    f = WidebandTOAFitter(bundle, model, device="cpu", fused=False)
    dx, covn, chi2 = _step(f, "f64")
    no = f._noffset
    want = ref[f"step/{stem}/f64/dx"][no:]
    assert _rel(dx, want) <= 1e-8
    assert chi2 == pytest.approx(float(ref[f"step/{stem}/f64/chi2"]),
                                 rel=1e-9)
    assert _rel(covn, ref[f"step/{stem}/f64/covn"]) <= 1e-8


@pytest.mark.parametrize("stem", GOLDENS)
def test_mixed_step_matches_reference(ref, stem, monkeypatch):
    """``fused='mixed'`` through the joint-Gram kernel's plain version
    and the refined solves (forced on the CPU, as on the card), at 2n
    stacked rows, against the reference's mixed step and its f64 step
    at the step gates: dx 2e-3 of the largest component, chi2 1e-3
    relative, normalized covariance 5e-3."""
    monkeypatch.setenv("PINT_TPU_TORCH_FUSED_INTERIOR", "force")
    monkeypatch.setenv("PINT_TPU_TORCH_SOLVE_IR", "force")
    model, bundle = _state(ref, stem)
    f = WidebandTOAFitter(bundle, model, device="cpu", fused="mixed")
    assert f._step_mode() == "mixed"
    dx, covn, chi2 = _step(f, "mixed")
    no = f._noffset
    for mode in ("mixed", "f64"):
        want = ref[f"step/{stem}/{mode}/dx"][no:]
        assert _rel(dx, want) <= 2e-3, mode
        assert chi2 == pytest.approx(
            float(ref[f"step/{stem}/{mode}/chi2"]), rel=1e-3), mode
        assert _rel(covn, ref[f"step/{stem}/{mode}/covn"]) <= 5e-3, mode


def test_stacked_design_and_noise(compiled):
    """The stacked system: the offset column is 1 on the TOA rows and 0
    on the DM rows, the DM block's basis rows are zero, its variances
    are the scaled DM sigmas squared, and the DM rows of the design are
    minus d(dm_model)/dx."""
    model, bundle = compiled("golden17").model, compiled("golden17").bundle
    f = WidebandTOAFitter(bundle, model, device="cpu")
    x0 = f.cm.x0()
    n = bundle.ntoa
    r, M, Nd = f._step_inputs(x0)
    T, phi = f._step_noise(x0)
    assert r.shape == (2 * n,) and M.shape[0] == 2 * n == T.shape[0]
    assert torch.all(M[:n, 0] == 1) and torch.all(M[n:, 0] == 0)
    assert torch.all(T[n:] == 0) and float(T[:n].abs().max()) > 0
    torch.testing.assert_close(Nd[n:], f.cm.scaled_dm_sigma(x0) ** 2,
                               rtol=0, atol=0)
    dm_jac = torch.func.jacfwd(f.cm.dm_model)(x0)
    torch.testing.assert_close(M[n:, 1:], -dm_jac, rtol=1e-12, atol=1e-30)


def _wb_table(n=64, seed=2, dme=2e-4):
    return make_test_pulsar(
        "PSR J1234+5678\nF0 315.4 1\nF1 -6.2e-16 1\nPEPOCH 55000\n"
        "DM 21.7 1\nEFAC -f L-wide 1.1\n", ntoa=n, seed=seed,
        device="cpu", dm_error=dme)


def test_auto_fitter_routes_wideband():
    """Wideband TOAs go to WidebandDownhillFitter, or WidebandTOAFitter
    with downhill=False, from a host table (its pp_dm flags) or a bundle
    (its DM measurements)."""
    model, toas = _wb_table()
    assert is_wideband(toas)
    dm, dme = get_dm_measurements(toas)
    assert np.all(np.isfinite(dm)) and np.all(dme == 2e-4)
    assert type(auto_fitter(toas, model, device="cpu")) is (
        WidebandDownhillFitter)
    assert type(auto_fitter(toas, model, downhill=False,
                            device="cpu")) is WidebandTOAFitter
    bundle = model.compile(toas, device="cpu").bundle
    assert type(auto_fitter(bundle, model, device="cpu")) is (
        WidebandDownhillFitter)


def test_wideband_refusals(ref):
    """The reference's refusals: narrowband TOAs, a missing pp_dme,
    fused=True (the streaming basis is TOA-indexed).  full_cov=True is no
    refusal: both fitters take the dense step over the 2n stacked rows,
    their first step (WidebandDownhillFitter's first proposal) the
    reference's f64 dense step on the same inputs: dx within 1e-10 of
    its largest component, the normalized covariance 1e-10 and chi2
    1e-10 relative."""
    model, toas = _wb_table(n=40)
    narrow = dict(toas, flags=[{"f": f["f"]} for f in toas["flags"]])
    with pytest.raises(PintTpuError, match="pp_dm"):
        WidebandTOAFitter(narrow, model, device="cpu")
    missing = dict(toas, flags=[dict(f) for f in toas["flags"]])
    del missing["flags"][7]["pp_dme"]
    with pytest.raises(PintTpuError, match="pp_dme"):
        WidebandTOAFitter(missing, model, device="cpu")
    with pytest.raises(PintTpuError, match="stacked"):
        WidebandTOAFitter(toas, model, device="cpu", fused=True)
    f = WidebandTOAFitter(toas, model, device="cpu", full_cov=True)
    x0 = f.cm.x0()
    xn, (covn, _), chi2, _ = f._gn_step(x0, f._step_mode())
    assert _rel(xn.numpy(), ref["dense/dx"][1:]) <= 1e-10
    assert _rel(covn.numpy(), ref["dense/covn"]) <= 1e-10
    assert float(chi2) == pytest.approx(float(ref["dense/chi2"]), rel=1e-10)
    d = WidebandDownhillFitter(toas, model, device="cpu", full_cov=True)
    dx, (covn, _), _, _ = d._make_proposal()(x0)
    assert _rel(dx.numpy(), ref["dense/dx"][1:]) <= 1e-10
    assert _rel(covn.numpy(), ref["dense/covn"]) <= 1e-10


def test_dmjump_absorbs_receiver_offset():
    """A DM-measurement offset on one receiver is absorbed by a free
    DMJUMP (the reference's test_dmjump_absorbs_receiver_offset), while
    DM stays at its true value."""
    model, toas = _wb_table(n=120, seed=4)
    for i, f in enumerate(toas["flags"]):
        if f["f"] == "S-wide":
            f["pp_dm"] = repr(float(f["pp_dm"]) + 3e-3)
    m = get_model("PSR J1234+5678\nF0 315.4 1\nF1 -6.2e-16 1\n"
                  "PEPOCH 55000\nDM 21.7 1\nEFAC -f L-wide 1.1\n"
                  "DMJUMP -f S-wide 0 1\n")
    WidebandTOAFitter(toas, m, device="cpu").fit_toas(maxiter=5)
    assert abs(abs(float(m.params["DMJUMP1"].value)) - 3e-3) < 2e-4
    assert float(m.params["DM"].value) == pytest.approx(21.7, abs=2e-4)


def test_msp_wideband_par_shapes():
    """The card's wideband MSP, cut to 12 DMX ranges and 256 TOAs: the
    composition (DMJUMP free, DMEFAC/DMEQUAD), the stacked shapes, and a
    downhill fit from the par values served on its native rung."""
    model, toas = make_test_pulsar(
        msp_wideband_par(12), ntoa=256, start_mjd=53000.0,
        end_mjd=57500.0, seed=0, iterations=1, orbit=True,
        orbit_in_phase=True, freqs=MSP_FREQS, device="cpu", dm_error=2e-4)
    f = auto_fitter(toas, model, device="cpu")
    assert isinstance(f, WidebandDownhillFitter)
    assert len(f.cm.free_names) == 30 and "DMJUMP1" in f.cm.free_names
    r, M, _ = f._combined_residuals(f.cm.x0()), f._combined_design(
        f.cm.x0()), None
    assert r.shape == (512,) and M.shape == (512, 31)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DegeneracyWarning)
        chi2 = f.fit_toas()
    assert math.isfinite(chi2) and f.guard_report.rung == "native"
    # ~2n for a consistent model
    assert chi2 < 2.0 * 512


@pytest.mark.gpu
def test_wideband_fit_on_card_goes_through_the_kernel():
    """On the card WidebandTOAFitter takes the mixed step, and every step
    launches the joint-Gram kernel over the 2n stacked rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    model, toas = make_test_pulsar(
        msp_wideband_par(12), ntoa=2048, start_mjd=53000.0,
        end_mjd=57500.0, seed=0, iterations=1, orbit=True,
        orbit_in_phase=True, freqs=MSP_FREQS, device="cuda", dm_error=2e-4)
    f = WidebandTOAFitter(toas, model, device="cuda")
    before = fused_gram.fused_gram_joint_cuda.launches
    chi2 = f.fit_toas(maxiter=3)
    assert f.mode == "mixed" and math.isfinite(chi2)
    # every step a replay of the step program, whose capture's warm-up
    # call launched the kernel once more
    assert f.cm.programs.replays == f.steps_taken
    assert fused_gram.fused_gram_joint_cuda.launches - before == (
        f.steps_taken + f.cm.programs.captures)
