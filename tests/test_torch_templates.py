"""The port's photon templates (``pint_tpu_torch/templates/``) and event
statistics (``pint_tpu_torch/eventstats.py``) against the JAX package.

- Parity, the reference run once for the module in a subprocess
  (tests/torch_reference.py): every primitive's density (and an
  energy-dependent one's) at the same phases within 1e-12 relative of the
  largest; ``LCTemplate.random`` with the same numpy rng draws the
  reference's photons, bitwise; ``LCFitter.loglikelihood`` within 1e-12
  relative, its fit within 1e-6 of the reference's parameters; Z^2_m and
  H within 1e-12 relative.
- Twins of ``tests/test_templates.py``'s twelve tests (the
  ``event_optimize`` CLI's template path without the CLI, which is ROADMAP
  A13) and of ``tests/test_derived_l6.py``'s
  ``test_template_fit_recovers_profile`` and ``test_eventstats_*``, at
  their gates, on the CPU.
"""

import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import run_reference  # noqa: E402

from pint_tpu_torch.eventstats import hm, sf_hm, sf_z2m, z2m  # noqa: E402
from pint_tpu_torch.templates import (  # noqa: E402
    LCBinnedProfile,
    LCEPrimitive,
    LCFitter,
    LCGaussian,
    LCGaussian2,
    LCLorentzian,
    LCTemplate,
    LCVonMises,
    read_gauss,
    read_prof,
    read_template,
    write_gauss,
    write_prof,
)

CPU = dict(device="cpu")
PRIMS = {
    "gauss": "LCGaussian(width=0.05, loc=0.3)",
    "vonmises": "LCVonMises(width=0.05, loc=0.3)",
    "lorentz": "LCLorentzian(width=0.02, loc=0.7)",
    "gauss2": "LCGaussian2(width=0.03, width2=0.08, loc=0.4)",
    "binned": "LCBinnedProfile(np.exp(-0.5 * ((np.arange(64) / 64 - 0.5)"
              " / 0.1) ** 2), loc=0.13)",
}
TRUTH = ("LCTemplate([LCGaussian(width=0.03, loc=0.3), "
         "LCGaussian(width=0.08, loc=0.7)], weights=[0.35, 0.25])")
START = ("LCTemplate([LCGaussian(width=0.05, loc=0.28), "
         "LCGaussian(width=0.05, loc=0.72)], weights=[0.3, 0.3])")

_SCRIPT = textwrap.dedent(f"""
from pint_tpu.eventstats import hm, z2m
from pint_tpu.templates import *

x = np.linspace(-0.2, 1.3, 3001)
for name, src in {PRIMS!r}.items():
    OUT[f"prim/{{name}}"] = np.asarray(eval(src)(x))
e = LCEPrimitive(LCGaussian(width=0.05, loc=0.4), width_slope=-0.02,
                 loc_slope=0.07)
u = np.linspace(-1.0, 1.5, len(x))
OUT["prim/energy"] = np.asarray(e(x, log10_ens=u))

truth = {TRUTH}
phases = truth.random(4000, rng=np.random.default_rng(5))
OUT["random"] = phases
et = LCTemplate([LCEPrimitive(LCGaussian(width=0.04, loc=0.30),
                              width_slope=-0.008, loc_slope=0.050)],
                weights=[0.65])
le = np.random.default_rng(17).uniform(-1.0, 1.5, 1500)
OUT["random_energy"] = et.random(1500, rng=np.random.default_rng(18),
                                 log10_ens=le)
start = {START}
f = LCFitter(start, phases)
OUT["ll0"] = np.array(float(f.loglikelihood()))
OUT["ll_fit"] = np.array(f.fit())
OUT["fit"] = start.get_parameters()
OUT["errors"] = f.errors()
w = np.random.default_rng(6).uniform(size=len(phases))
OUT["ll_weighted"] = np.array(float(LCFitter({START}, phases,
                                             weights=w).loglikelihood()))
OUT["z2m"] = z2m(phases, m=6)
OUT["z2m_w"] = z2m(phases, m=6, weights=w)
OUT["hm"] = np.array(hm(phases))
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(_SCRIPT,
                         tmp_path_factory.mktemp("ref") / "templates.npz")


def _max_rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# -- parity ---------------------------------------------------------------
@pytest.mark.parametrize("name", list(PRIMS))
def test_primitive_density_matches_reference(ref, name):
    x = np.linspace(-0.2, 1.3, 3001)
    got = eval(PRIMS[name])(x)
    assert _max_rel(got, ref[f"prim/{name}"]) <= 1e-12


def test_energy_primitive_matches_reference(ref):
    x = np.linspace(-0.2, 1.3, 3001)
    e = LCEPrimitive(LCGaussian(width=0.05, loc=0.4), width_slope=-0.02,
                     loc_slope=0.07)
    got = e(x, log10_ens=np.linspace(-1.0, 1.5, len(x)))
    assert _max_rel(got, ref["prim/energy"]) <= 1e-12


def test_random_draws_are_the_references(ref):
    """The same numpy rng draws the reference's photons, bitwise (the
    rejection draws are the reference's call for call; only the density
    is the port's), with and without energies; a torch Generator draws
    on its own device and returns a tensor."""
    truth = eval(TRUTH)
    np.testing.assert_array_equal(
        truth.random(4000, rng=np.random.default_rng(5), **CPU),
        ref["random"])
    et = LCTemplate([LCEPrimitive(LCGaussian(width=0.04, loc=0.30),
                                  width_slope=-0.008, loc_slope=0.050)],
                    weights=[0.65])
    le = np.random.default_rng(17).uniform(-1.0, 1.5, 1500)
    np.testing.assert_array_equal(
        et.random(1500, rng=np.random.default_rng(18), log10_ens=le, **CPU),
        ref["random_energy"])
    g = torch.Generator()
    g.manual_seed(4)
    ph = truth.random(1000, rng=g)
    assert isinstance(ph, torch.Tensor) and ph.shape == (1000,)
    assert float(ph.min()) >= 0.0 and float(ph.max()) < 1.0


def test_loglikelihood_and_fit_match_reference(ref):
    """loglikelihood within 1e-12 relative (plain and weighted); the fit
    (scipy L-BFGS-B on autograd gradients) within 1e-6 of the reference's
    parameters and its errors within 1e-4 relative."""
    phases = ref["random"]
    start = eval(START)
    f = LCFitter(start, phases, **CPU)
    assert float(f.loglikelihood()) == pytest.approx(float(ref["ll0"]),
                                                     rel=1e-12)
    w = np.random.default_rng(6).uniform(size=len(phases))
    fw = LCFitter(eval(START), phases, weights=w, **CPU)
    assert float(fw.loglikelihood()) == pytest.approx(
        float(ref["ll_weighted"]), rel=1e-12)
    ll = f.fit()
    assert ll == pytest.approx(float(ref["ll_fit"]), rel=1e-10)
    np.testing.assert_allclose(start.get_parameters(), ref["fit"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(f.errors(), ref["errors"], rtol=1e-4)


def test_eventstats_match_reference(ref):
    phases = ref["random"]
    w = np.random.default_rng(6).uniform(size=len(phases))
    assert _max_rel(z2m(phases, m=6, **CPU), ref["z2m"]) <= 1e-12
    assert _max_rel(z2m(phases, m=6, weights=w, **CPU), ref["z2m_w"]) <= (
        1e-12)
    assert hm(phases, **CPU) == pytest.approx(float(ref["hm"]), rel=1e-12)


# -- twins of tests/test_templates.py --------------------------------------
@pytest.mark.parametrize("prim", [
    LCGaussian(width=0.05, loc=0.3),
    LCVonMises(width=0.05, loc=0.3),
    LCLorentzian(width=0.02, loc=0.7),
    LCGaussian2(width=0.03, width2=0.08, loc=0.4),
    LCBinnedProfile(np.exp(-0.5 * ((np.arange(64) / 64 - 0.5) / 0.1) ** 2)),
])
def test_primitive_normalization(prim):
    """Every primitive is a density: integral over one cycle = 1."""
    x = (np.arange(20000) + 0.5) / 20000
    f = np.asarray(prim(x))
    assert f.min() >= 0
    assert np.trapezoid(np.r_[f, f[:1]], np.r_[x, 1.0 + x[:1]]) == (
        pytest.approx(1.0, abs=2e-3)
    )


def test_gaussian2_asymmetry_and_continuity():
    p = LCGaussian2(width=0.02, width2=0.08, loc=0.5)
    x = np.linspace(0.3, 0.7, 4001)
    f = np.asarray(p(x))
    ipk = np.argmax(f)
    assert x[ipk] == pytest.approx(0.5, abs=1e-3)
    # trailing side is wider: density at loc+0.05 > density at loc-0.05
    assert p(np.array([0.55]))[0] > p(np.array([0.45]))[0]
    # continuous at the peak (no jump across dphi=0)
    assert abs(f[ipk + 1] - f[ipk - 1]) < 0.1 * f[ipk]


def test_gauss_file_roundtrip(tmp_path):
    tmpl = LCTemplate(
        [LCGaussian(width=0.04, loc=0.21), LCGaussian(width=0.1, loc=0.6)],
        weights=[0.35, 0.25],
    )
    errs = np.abs(np.random.default_rng(0).normal(0.01, 0.002, 6))
    path = tmp_path / "t.gauss"
    write_gauss(tmpl, path, errors=errs)
    back, errs2 = read_gauss(path)
    np.testing.assert_allclose(
        back.get_parameters(), tmpl.get_parameters(), atol=1e-6
    )
    np.testing.assert_allclose(errs2, errs, atol=1e-5)
    # dispatch helper
    t3, e3 = read_template(str(path))
    np.testing.assert_allclose(
        t3.get_parameters(), tmpl.get_parameters(), atol=1e-6
    )


def test_prof_file_roundtrip(tmp_path):
    tmpl = LCTemplate([LCGaussian(width=0.05, loc=0.4)], weights=[0.8])
    path = tmp_path / "t.prof"
    write_prof(tmpl, path, nbins=128)
    back = read_prof(path)
    x = (np.arange(1024) + 0.5) / 1024
    f0 = np.asarray(tmpl(x))
    f1 = np.asarray(back(x))
    # binned + background-split representation: few-% density agreement
    assert np.max(np.abs(f1 - f0)) < 0.05 * f0.max()


def test_fit_recovers_template_and_errors():
    truth = LCTemplate(
        [LCGaussian2(width=0.02, width2=0.05, loc=0.3)], weights=[0.6]
    )
    rng = np.random.default_rng(5)
    phases = truth.random(4000, rng=rng, **CPU)
    start = LCTemplate(
        [LCGaussian2(width=0.04, width2=0.04, loc=0.33)], weights=[0.4]
    )
    f = LCFitter(start, phases, **CPU)
    ll = f.fit()
    assert np.isfinite(ll)
    errs = f.errors()
    assert errs.shape == start.get_parameters().shape
    assert np.all(errs[:1] > 0) and np.all(np.isfinite(errs))
    got = start.get_parameters()
    want = truth.get_parameters()
    # weight, widths, loc recovered within 5 sigma (or 0.02 absolute)
    for g, w, e in zip(got, want, errs):
        assert abs(g - w) < max(5 * e, 0.02), (g, w, e)
    # loc error should be small and positive for a 4000-photon peak
    assert 0 < errs[-1] < 0.01


def test_lorentzian_fit():
    truth = LCTemplate([LCLorentzian(width=0.01, loc=0.52)], weights=[0.5])
    rng = np.random.default_rng(8)
    phases = truth.random(3000, rng=rng, **CPU)
    start = LCTemplate([LCLorentzian(width=0.03, loc=0.5)], weights=[0.3])
    f = LCFitter(start, phases, **CPU)
    f.fit()
    got = start.get_parameters()
    assert got[0] == pytest.approx(0.5, abs=0.08)   # weight
    assert got[1] == pytest.approx(0.01, abs=0.01)  # width
    assert got[2] == pytest.approx(0.52, abs=0.01)  # loc


def test_binned_profile_shift_fit():
    """A .prof template's only free shape parameter is the phase
    shift: the fitter localizes it."""
    base = LCTemplate([LCGaussian(width=0.04, loc=0.5)], weights=[0.7])
    rng = np.random.default_rng(9)
    phases = (base.random(3000, rng=rng, **CPU) + 0.1) % 1.0  # shifted data
    vals = np.asarray(base(np.linspace(0, 1, 128, endpoint=False)))
    tmpl = LCTemplate([LCBinnedProfile(vals)], weights=[0.7])
    f = LCFitter(tmpl, phases, **CPU)
    f.fit()
    assert tmpl.primitives[0].params[1] % 1.0 == pytest.approx(
        0.1, abs=0.02
    )
    assert tmpl.primitives[0].params[0] == 1.0  # pinned scale


def test_event_optimize_fit_template_path(tmp_path):
    """The template half of event_optimize's --fit-template path (the
    CLI itself is ROADMAP A13): photons pulsed at phase 0.5 with width
    0.05 over a background, the .gauss starting template refit on them,
    written back with Hessian errors and read again."""
    rng = np.random.default_rng(6)
    ph = rng.uniform(size=5000)
    keep = rng.uniform(size=len(ph)) < (
        0.1 + np.exp(-0.5 * ((ph - 0.5) / 0.05) ** 2)
    )
    gauss = tmp_path / "t.gauss"
    gauss.write_text(
        "const = 0.5\nphas1 = 0.45\nfwhm1 = 0.16\nampl1 = 0.5\n"
    )
    tmpl, _ = read_template(gauss)
    f = LCFitter(tmpl, ph[keep], **CPU)
    f.fit()
    out = tmp_path / "post.par.gauss"
    write_gauss(tmpl, out, errors=f.errors())
    refit, errs = read_gauss(out)
    assert errs is not None and np.all(np.isfinite(errs))
    assert abs(refit.primitives[0].params[1] - 0.5) < 0.03
    assert abs(refit.primitives[0].params[0] - 0.05) < 0.03


def test_read_template_legacy_colon_format(tmp_path):
    p = tmp_path / "legacy.txt"
    p.write_text("# two peaks\n0.4:0.05:0.3\n0.2:0.02:0.7\n")
    tmpl, errs = read_template(p)
    assert errs is None
    assert len(tmpl.primitives) == 2
    np.testing.assert_allclose(tmpl.weights, [0.4, 0.2])
    assert tmpl.primitives[1].params[1] == pytest.approx(0.7)


def test_write_gauss_preserves_tiny_errors(tmp_path):
    tmpl = LCTemplate([LCGaussian(width=0.04, loc=0.2)], weights=[0.5])
    errs = np.array([0.01, 1e-3, 3e-7])  # tiny phase error
    path = tmp_path / "tiny.gauss"
    write_gauss(tmpl, path, errors=errs)
    _, back = read_gauss(path)
    assert back[-1] == pytest.approx(3e-7, rel=1e-3)  # not floored to 0


def test_lce_primitive_basic_properties():
    """Energy-dependent wrapper: reduces to the base at the pivot
    (u=0), shifts/sharpens away from it, stays normalized per energy."""
    base = LCGaussian(width=0.05, loc=0.4)
    p = LCEPrimitive(
        LCGaussian(width=0.05, loc=0.4),
        width_slope=-0.02, loc_slope=0.07,
    )
    grid = np.linspace(0, 1, 4001)[:-1]
    # pivot energy: identical to the base
    np.testing.assert_allclose(
        np.asarray(p(grid, log10_ens=0.0)), np.asarray(base(grid)),
        rtol=1e-12,
    )
    # one decade up: loc moved by +0.07, width narrowed by 0.02
    f_hi = np.asarray(p(grid, log10_ens=1.0))
    assert abs(grid[np.argmax(f_hi)] - 0.47) < 2e-3
    assert f_hi.max() > np.asarray(base(grid)).max()  # narrower = taller
    # normalized at every energy
    for u in (-1.0, 0.0, 1.0):
        f = np.asarray(p(grid, log10_ens=u))
        assert abs(f.mean() - 1.0) < 1e-6


def test_lce_template_fit_recovery():
    """Photons whose peak drifts with energy: the energy-dependent fit
    recovers the slopes and beats the energy-blind one."""
    rng = np.random.default_rng(17)
    n = 6000
    log10_ens = rng.uniform(-1.0, 1.5, n)  # 0.1 .. ~30 GeV
    true = LCTemplate(
        [LCEPrimitive(LCGaussian(width=0.04, loc=0.30),
                      width_slope=-0.008, loc_slope=0.050)],
        weights=[0.65],
    )
    phases = true.random(n, rng=rng, log10_ens=log10_ens, **CPU)

    start = LCTemplate(
        [LCEPrimitive(LCGaussian(width=0.06, loc=0.34))],
        weights=[0.5],
    )
    lcf = LCFitter(start, phases, log10_ens=log10_ens, **CPU)
    ll = lcf.fit()
    assert np.isfinite(ll)
    errs = lcf.errors()
    w0, loc0, wslope, lslope = start.primitives[0].params
    assert abs(w0 - 0.04) < 0.01
    assert abs(loc0 - 0.30) < 0.01
    assert abs(lslope - 0.050) < 0.012
    assert abs(wslope - (-0.008)) < 0.01
    assert np.all(np.isfinite(errs))
    # the energy-dependent fit must beat the energy-blind one
    blind = LCTemplate(
        [LCGaussian(width=0.06, loc=0.34)], weights=[0.5]
    )
    ll_blind = LCFitter(blind, phases, **CPU).fit()
    assert ll > ll_blind + 10.0
    with pytest.raises(ValueError, match="log10_ens"):
        LCFitter(start, phases, **CPU)


# -- twins of tests/test_derived_l6.py -------------------------------------
def test_template_fit_recovers_profile():
    rng = np.random.default_rng(5)
    true = eval(TRUTH)
    phases = true.random(4000, rng=rng, **CPU)
    fit_t = eval(START)
    f = LCFitter(fit_t, phases, **CPU)
    ll = f.fit()
    assert np.isfinite(ll)
    locs = sorted(p.loc for p in fit_t.primitives)
    assert locs[0] == pytest.approx(0.3, abs=0.01)
    assert locs[1] == pytest.approx(0.7, abs=0.02)
    w = np.sort(fit_t.weights)
    assert w[1] == pytest.approx(0.35, abs=0.05)


def test_eventstats_uniform_and_pulsed():
    rng = np.random.default_rng(0)
    uni = rng.uniform(size=2000)
    h_uni = hm(uni, **CPU)
    assert h_uni < 25.0  # no significant detection
    assert 0.0 < sf_hm(h_uni) <= 1.0
    # strongly pulsed: narrow Gaussian peak
    pulsed = np.mod(0.3 + 0.02 * rng.normal(size=2000), 1.0)
    h_pul = hm(pulsed, **CPU)
    assert h_pul > 500.0
    z = z2m(pulsed, m=4, **CPU)
    assert z.shape == (4,) and np.all(np.diff(z) >= 0)
    assert sf_z2m(z[-1], 4) < 1e-10


def test_eventstats_weighted():
    rng = np.random.default_rng(1)
    sig = np.mod(0.5 + 0.03 * rng.normal(size=500), 1.0)
    bkg = rng.uniform(size=2000)
    ph = np.concatenate([sig, bkg])
    w = np.concatenate([np.full(500, 0.9), np.full(2000, 0.1)])
    assert hm(ph, weights=w, **CPU) > hm(ph, **CPU)  # weights sharpen it


@pytest.mark.gpu
def test_template_loglikelihood_card_matches_cpu():
    """The template log-likelihood of 1e5 photons, and its gradient, on
    the card against the CPU: within 1e-10 relative; H within 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    truth = eval(TRUTH)
    phases = truth.random(100_000, rng=np.random.default_rng(2), **CPU)
    p = eval(START).get_parameters()
    out = {}
    for dev in ("cuda", "cpu"):
        f = LCFitter(eval(START), phases, device=dev)
        val, grad = f._objective(p)
        out[dev] = (val, grad, hm(phases, device=dev))
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-10)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-10,
                               atol=1e-10 * np.max(np.abs(out["cpu"][1])))
    assert out["cuda"][2] == pytest.approx(out["cpu"][2], rel=1e-9)
