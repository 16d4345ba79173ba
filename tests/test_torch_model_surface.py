"""The rest of the port's model surface: the component registry,
``TimingModel`` access, ``clone``, ``compare``, the parse cache,
``binaryconvert``, polycos and ``make_population``.

- The registry: the same registered classes as the reference, each
  accepting the same par names (``accepted_param_names``), and the
  model builder's choice from it the reference's, component for component and
  in order, on all 23 goldens; ``fittable_params`` and
  ``free_params_component`` the reference's there too.
- ``clone``: golden14 (JUMP, two DMX ranges) with an ECORR line: the
  clone's GLS step equals the original's bitwise, its one-step GLS fit
  the reference's clone's (values within 1e-3 sigma, uncertainties 2e-6
  relative), and changing the
  clone leaves the original alone (no tensor, parameter or TZR memo
  shared).
- The parse cache: a hit is a clone, the data environment is part of
  the key, ``PINT_TPU_TORCH_PARSE_CACHE=0`` turns it off and the size
  knob bounds it.
- ``compare`` string for string the reference's: each golden against
  itself plus one line, golden1 against golden2, golden23 (TCB) against
  its TDB reading.
- Twins of ``tests/test_derived_l6.py``'s binaryconvert tests (and a
  third: DD -> DDS and ELL1H -> DD, each converted value the
  reference's to 1e-15 relative) and polycos tests (the oracle's phases
  computed by the reference's subprocess; the coefficients the
  reference's within 1e-9 cycles over the span).
- ``make_population`` as ``tests/test_onchip_accuracy.py:497`` uses it:
  the reference's par texts' values and shared TOAs, and each variant's
  residuals the same whether batched with the others or alone.

The reference and the oracle run once for the module in a subprocess
(tests/torch_reference.py).
"""

import json
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from torch_ingest_env import (  # noqa: E402
    ALL_STEMS,
    DATADIR,
    golden_env,
    port_ingest_env,
)
from torch_reference import run_reference  # noqa: E402

from pint_tpu_torch.models import builder  # noqa: E402
from pint_tpu_torch.models.builder import get_model  # noqa: E402
from pint_tpu_torch.models.component import Component  # noqa: E402
from pint_tpu_torch.timebase.hostdd import HostDD  # noqa: E402

PAR = """
PSR              J1744-1134
F0               245.4261196898081  1
F1               -5.38e-16          1
PEPOCH           55000
DM               3.1380             1
"""
ELL1 = PAR + """
BINARY           ELL1
PB               1.5
A1               3.2
TASC             55000.1
EPS1             1.2e-5
EPS2             -0.7e-5
"""
ELL1_RATES = ELL1 + "EPS1DOT          3.0e-16\nEPS2DOT          -1.0e-16\n"
DD_GAMMA = PAR + """
BINARY           DD
PB               1.5
A1               3.2
T0               55000.1
ECC              1e-5
OM               30.0
GAMMA            1e-6
"""
DD_SINI = PAR + """
BINARY           DD
PB               1.5
A1               3.2
T0               55000.1
ECC              1e-3
OM               30.0
M2               0.3
SINI             0.9
"""
ELL1H = PAR + """
BINARY           ELL1H
PB               1.5
A1               3.2
TASC             55000.1
EPS1             1.2e-5
EPS2             -0.7e-5
H3               2e-7
STIGMA           0.4
"""
#: (par name, target) of each conversion held to the reference
CONVERSIONS = [("ELL1", "DD"), ("ELL1_RATES", "DD"), ("DD_SINI", "ELL1"),
               ("DD_SINI", "DDS"), ("ELL1H", "DD")]
#: golden14 (JUMP, DMX) with ECORR: the clone case
CLONE_PAR = (DATADIR / "golden14.par").read_text() + "ECORR -f L-wide 0.9\n"
#: a perturbation line for each golden's compare
PLUS = "\nF2 1e-25\n"
POLY_MJDS = 55100.0 + np.sort(np.random.default_rng(21).uniform(0.01, 0.49,
                                                                 16))
POP_PAR = ("PSR ONCHIP\nF0 151.3 1\nF1 -1.5e-15 1\nPEPOCH 55000\n"
           "DM 8.9 1\n")

_SCRIPT = r"""
import warnings
warnings.simplefilter("ignore")
from mpmath import mp, mpf
from ingest_env import INGEST_STEMS, golden_ingest_env
from oracle.mp_pipeline import OraclePulsar
from pint_tpu.binaryconvert import convert_binary
from pint_tpu.fitting import GLSFitter
from pint_tpu.models.builder import get_model, get_model_and_toas
from pint_tpu.models.component import Component
from pint_tpu.polycos import Polycos
from pint_tpu.simulation import make_population
from pint_tpu.timebase.hostdd import HostDD
import pint_tpu.models.builder  # fills the registry

data = "tests/datafile"
info = {"registry": {n: sorted(c.accepted_param_names())
                     for n, c in Component.component_types.items()}}
goldens = {}
with golden_ingest_env():
    for i in range(1, 24):
        stem = f"golden{i}"
        par = open(f"{data}/{stem}.par").read()
        m = get_model(par)
        goldens[stem] = dict(
            components=list(m.components),
            fittable=m.fittable_params,
            free_component=[[n, type(c).__name__]
                            for n, c in m.free_params_component()],
            compare=m.compare(get_model(par + PLUS)))
    g1 = get_model(f"{data}/golden1.par")
    g2 = get_model(f"{data}/golden2.par")
    info["compare_1_2"] = g1.compare(g2)
    p23 = open(f"{data}/golden23.par").read()
    info["compare_23"] = get_model(p23).compare(
        get_model(p23.replace("UNITS TCB", "UNITS TDB")))
    model, toas = get_model_and_toas(CLONE_PAR, f"{data}/golden14.tim")
    clone = model.clone()
    f = GLSFitter(toas, clone, fused=False)
    f.fit_toas(maxiter=1)
    info["clone_fit"] = {n: [clone.params[n].internal().to_float()
                             if isinstance(clone.params[n].internal(), HostDD)
                             else clone.params[n].internal(),
                             clone.params[n].internal_uncertainty()]
                         for n in f.cm.free_names}
info["goldens"] = goldens

conv = {}
for name, target in CONVERSIONS:
    out = convert_binary(get_model(PARS[name]), target)
    vals = {}
    for n, p in out.params.items():
        v = p.internal()
        if v is None or isinstance(v, (str, bool)):
            continue
        if isinstance(v, HostDD):
            v = [float(v.hi), float(v.lo)]
        elif isinstance(v, tuple) and isinstance(v[1], HostDD):
            v = [float(v[0]), float(v[1].hi), float(v[1].lo)]
        elif isinstance(v, tuple):
            v = [float(x) for x in v]
        else:
            v = [float(v)]
        vals[n] = v
    conv[f"{name}->{target}"] = [list(out.components), vals]
info["conversions"] = conv

m = get_model(PARS["PAR"])
pcs = Polycos.generate(m, 55000.0, 55000.25, obs="@", ncoeff=9)
OUT["poly/coeffs"] = np.array([e.coeffs for e in pcs.entries])
OUT["poly/tmid"] = np.array([e.tmid_mjd for e in pcs.entries])
OUT["poly/rphase"] = np.array([[e.rphase_int, e.rphase_frac, e.f0]
                               for e in pcs.entries])
o = OraclePulsar(f"{data}/golden1.par", f"{data}/golden1.tim")
orc = []
with mp.workdps(30):
    for mjd in POLY_MJDS:
        day = int(mjd)
        toa = dict(freq=mpf(1400.0), day=day, frac=mpf(float(mjd)) - day,
                   err_us=mpf(1), obs="@", flags={})
        ph = o._absolute_phase(toa)[0]
        orc.append([float(mp.floor(ph)), float(ph - mp.floor(ph))])
OUT["poly/oracle"] = np.array(orc)

pars, toas = make_population(POP_PAR, 3, ntoa=40, seed=5, iterations=1)
pop = []
for p in pars:
    mm = get_model(p)
    pop.append({n: [float(mm.params[n].internal().hi),
                    float(mm.params[n].internal().lo)]
                if isinstance(mm.params[n].internal(), HostDD)
                else [float(mm.params[n].internal())]
                for n in mm.free_params})
info["population"] = pop
OUT["pop/day"] = toas.t.mjd_int
OUT["pop/hi"] = toas.t.sec.hi
OUT["pop/lo"] = toas.t.sec.lo
OUT["info"] = np.array(json.dumps(info))
"""

PARS = {"PAR": PAR, "ELL1": ELL1, "ELL1_RATES": ELL1_RATES,
        "DD_SINI": DD_SINI, "ELL1H": ELL1H}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_model_surface")
    script = (f"PLUS = {PLUS!r}\nCLONE_PAR = {CLONE_PAR!r}\n"
              f"CONVERSIONS = {CONVERSIONS!r}\nPARS = {PARS!r}\n"
              f"POLY_MJDS = {POLY_MJDS.tolist()!r}\n"
              f"POP_PAR = {POP_PAR!r}\n" + textwrap.dedent(_SCRIPT))
    out = run_reference(script, work / "ref.npz")
    out["info"] = json.loads(str(out["info"]))
    return out


@pytest.fixture(autouse=True)
def _fresh_parse_cache():
    builder.clear_parse_cache()
    yield
    builder.clear_parse_cache()


def test_registry_matches_reference(ref):
    want = ref["info"]["registry"]
    got = {n: sorted(c.accepted_param_names())
           for n, c in Component.component_types.items()}
    assert sorted(got) == sorted(want)
    for n in want:
        assert got[n] == want[n], n
    assert sorted(builder.SELECTABLE) == sorted(
        n for n in want if not n.startswith("Binary"))


@pytest.mark.parametrize("stem", ALL_STEMS)
def test_choice_and_access_match_reference(ref, stem):
    """The model builder's choice from the registry, component for component
    and in order, and the parameter access of the reference."""
    want = ref["info"]["goldens"][stem]
    with golden_env(stem), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        par = (DATADIR / f"{stem}.par").read_text()
        m = get_model(par)
        assert list(m.components) == want["components"]
        assert m.fittable_params == want["fittable"]
        assert [[n, type(c).__name__] for n, c in
                m.free_params_component()] == want["free_component"]
        assert m.compare(get_model(par + PLUS)) == want["compare"]
    for n in m.free_params:
        assert m[n] is m.params[n]
        assert getattr(m, n) is m.params[n]
    with pytest.raises(KeyError):
        m["NOT_A_PARAM"]
    with pytest.raises(AttributeError):
        m.NOT_A_PARAM


def test_compare_matches_reference(ref):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g1 = get_model(str(DATADIR / "golden1.par"))
        g2 = get_model(str(DATADIR / "golden2.par"))
        assert g1.compare(g2) == ref["info"]["compare_1_2"]
        p23 = (DATADIR / "golden23.par").read_text()
        got = get_model(p23).compare(
            get_model(p23.replace("UNITS TCB", "UNITS TDB")))
    assert got == ref["info"]["compare_23"]
    assert "PEPOCH" in got and got.count("*") > 1


def test_component_access():
    m = get_model(ELL1)
    spin = m.components["Spindown"]
    assert spin.has_param("F0") and not spin.has_param("PB")
    assert spin.F0 is spin.params["F0"]
    with pytest.raises(AttributeError):
        spin.PB
    binary = m.components["BinaryELL1"]
    assert binary.match_param_alias("pb") == "PB"
    assert binary.match_param_alias("NOPE") is None
    # add/remove: a duplicate refuses, a removed component is gone
    from pint_tpu_torch.exceptions import TimingModelError
    from pint_tpu_torch.models.spindown import Spindown

    with pytest.raises(TimingModelError, match="duplicate"):
        m.add_component(Spindown())
    m.remove_component("BinaryELL1")
    assert "BinaryELL1" not in m.components and "PB" not in m.params


def _step(model, toas):
    from pint_tpu_torch.fitting.gls import gauss_newton_step

    cm = model.compile(toas, device="cpu")
    return cm, gauss_newton_step(cm, cm.x0(), "f64")


def test_clone_ecorr_jump_dmx(ref):
    """A clone keeps ECORR, the JUMP and the DMX ranges: its GLS step is
    the original's bit for bit and its one-step fit the reference's
    clone's; changing it leaves the original alone."""
    from pint_tpu_torch.fitting import GLSFitter
    from pint_tpu_torch.models.builder import get_model_and_toas

    with port_ingest_env(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model, toas = get_model_and_toas(CLONE_PAR,
                                         str(DATADIR / "golden14.tim"))
        clone = model.clone()
        cm0, (x0, (c0, _), chi0, _) = _step(model, toas)
        cm1, (x1, (c1, _), chi1, _) = _step(clone, toas)
        assert cm0.free_names == cm1.free_names
        assert "JUMP1" in cm1.free_names and "DMX_0002" in cm1.free_names
        assert cm1.has_correlated_errors
        b0, b1 = (c.noise_basis_or_empty(c.x0())[0] for c in (cm0, cm1))
        assert b1.shape == b0.shape and b1.shape[1] > 0
        assert torch.equal(x0, x1) and torch.equal(c0, c1)
        assert float(chi0) == float(chi1)
        # the TZR memo is not carried; nothing mutable is shared
        absph = [c for c in clone.components.values()
                 if hasattr(c, "_tzr_memo")]
        assert all(c._tzr_memo is not o._tzr_memo for c, o in zip(
            absph, (model.components[type(c).__name__] for c in absph)))
        for name, comp in clone.components.items():
            assert comp is not model.components[name]
            for n, p in comp.params.items():
                assert p is not model.components[name].params[n]
        before = model.as_parfile()
        f = GLSFitter(toas, clone, fused=False, device="cpu")
        f.fit_toas(maxiter=1)
        assert model.as_parfile() == before
        assert clone.compare(model).count("*") >= len(f.cm.free_names) - 2
    want = ref["info"]["clone_fit"]
    assert sorted(want) == sorted(f.cm.free_names)
    for i, n in enumerate(f.cm.free_names):
        p = clone.params[n]
        v = p.internal()
        v = v.to_float() if isinstance(v, HostDD) else v
        unc = p.internal_uncertainty()
        wv, wunc = want[n]
        assert abs(float(v) - wv) <= 1e-3 * wunc, (n, v, wv, wunc)
        # 2e-6: on golden14 the port's and the reference's one-step f64
        # uncertainties of the near-degenerate DM and JUMP1 differ by
        # 8.5e-7 relative without the ECORR line and 1.2e-6 with it
        assert abs(unc / wunc - 1.0) <= 2e-6, (n, unc, wunc)


@pytest.fixture
def builds(monkeypatch):
    """The par texts parsed and built (not served by the cache)."""
    seen = []
    real = builder._build

    def spy(par):
        seen.append(par)
        return real(par)

    monkeypatch.setattr(builder, "_build", spy)
    return seen


def test_parse_cache_hit_is_a_clone(builds):
    a = get_model(ELL1)
    b = get_model(ELL1)
    assert len(builds) == 1
    assert a is not b and a.as_parfile() == b.as_parfile()
    assert repr(a) == repr(b) and a.compare(b).count("*") == 0
    b.params["F0"].value = HostDD(1.0)
    assert float(a.params["F0"].value.to_float()) == pytest.approx(
        245.4261196898081)
    c = get_model(ELL1)  # the cached copy was not changed through b
    assert c.compare(a).count("*") == 0 and len(builds) == 1
    # warnings of the par text replay on a hit
    text = ELL1 + "NOT_A_PARAMETER 3\n"
    with pytest.warns(builder.UnknownParameterWarning):
        get_model(text)
    with pytest.warns(builder.UnknownParameterWarning):
        m = get_model(text)
    assert len(builds) == 2
    assert m.unrecognized == {"NOT_A_PARAMETER": [["3"]]}
    # paths and file objects are never cached
    get_model(str(DATADIR / "golden1.par"))
    get_model(str(DATADIR / "golden1.par"))
    assert len(builds) == 4


def test_parse_cache_key_holds_the_environment(builds, monkeypatch,
                                               tmp_path):
    get_model(ELL1)
    monkeypatch.setenv("PINT_TPU_EOP", str(tmp_path / "other_eop"))
    get_model(ELL1)
    assert len(builds) == 2
    monkeypatch.setenv("PINT_TPU_CLOCK_DIR", str(tmp_path))
    monkeypatch.setenv("PINT_TPU_EPHEM_DIR", str(tmp_path))
    get_model(ELL1)
    get_model(ELL1)
    assert len(builds) == 3


def test_parse_cache_knobs(builds, monkeypatch):
    monkeypatch.setenv("PINT_TPU_TORCH_PARSE_CACHE", "0")
    get_model(ELL1)
    get_model(ELL1)
    assert len(builds) == 2 and len(builder._PARSE_CACHE) == 0
    monkeypatch.setenv("PINT_TPU_TORCH_PARSE_CACHE", "1")
    monkeypatch.setenv("PINT_TPU_TORCH_PARSE_CACHE_SIZE", "2")
    for text in (PAR, ELL1, DD_SINI, ELL1H):
        get_model(text)
    assert len(builder._PARSE_CACHE) == 2
    del builds[:]
    get_model(ELL1H)  # the newest two stay
    get_model(PAR)  # the oldest went
    assert builds == [PAR]


def test_parse_cache_tzr_anchor_reingests():
    """A hit ingests the TZR arrival anew (the memo is not carried) and
    anchors the phase as a fresh build does."""
    par = (DATADIR / "golden22.par").read_text()
    with port_ingest_env(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = get_model(par)
        b = get_model(par)
        ma = a.components["AbsPhase"]._tzr_memo
        mb = b.components["AbsPhase"]._tzr_memo
    assert ma is not mb and ma[0] == mb[0]
    for col in ("clock_corr_s", "ssb_obs_pos"):
        np.testing.assert_array_equal(getattr(ma[1], col),
                                      getattr(mb[1], col))


# -- binaryconvert (twins of tests/test_derived_l6.py) ----------------------
def _toas(model, n=120, seed=1):
    from pint_tpu_torch.simulation import make_fake_toas_uniform
    from pint_tpu_torch.toas.ingest import ingest_barycentric

    rng = np.random.default_rng(seed)
    toas = make_fake_toas_uniform(
        54000, 56000, n, model, error_us=1.0,
        freq_mhz=np.where(np.arange(n) % 2, 1400.0, 2300.0),
        add_noise=False, device="cpu")
    toas.t = toas.t.add_seconds(rng.normal(0, 1e-6, n))
    ingest_barycentric(toas)
    return toas


def test_binaryconvert_ell1_dd_roundtrip():
    from pint_tpu_torch.binaryconvert import convert_binary

    m = get_model(ELL1)
    toas = _toas(m, n=60)

    def centered(model):
        cm = model.compile(toas, device="cpu")
        d = cm.delay(cm.x0()).numpy()
        return d - d.mean()  # ELL1 absorbs -3/2 a1 eps1 into TASC

    d0 = centered(m)
    m_dd = convert_binary(m, "DD")
    assert m_dd.components["BinaryDD"]
    d1 = centered(m_dd)
    # ELL1 truncation: x e^2 and x e (nb x) cross terms ~ 1e-8 here
    assert np.max(np.abs(d1 - d0)) < 3e-8
    m_back = convert_binary(m_dd, "ELL1")
    np.testing.assert_allclose(centered(m_back), d0, atol=1e-10)


def test_binaryconvert_rate_parameters():
    """EPS1DOT/EPS2DOT <-> OMDOT/EDOT round trip preserves the rates."""
    from pint_tpu_torch.binaryconvert import convert_binary
    from pint_tpu_torch.exceptions import TimingModelError

    m_dd = convert_binary(get_model(ELL1_RATES), "DD")
    assert m_dd.params["OMDOT"].value is not None
    assert m_dd.params["EDOT"].value is not None
    m_back = convert_binary(m_dd, "ELL1")
    assert float(m_back.params["EPS1DOT"].value) == pytest.approx(
        3.0e-16, rel=1e-9)
    assert float(m_back.params["EPS2DOT"].value) == pytest.approx(
        -1.0e-16, rel=1e-9)
    # GAMMA cannot be represented in ELL1 -> must raise, not drop
    with pytest.raises(TimingModelError, match="GAMMA"):
        convert_binary(get_model(DD_GAMMA), "ELL1")


@pytest.mark.parametrize("name,target", CONVERSIONS)
def test_binaryconvert_matches_reference(ref, name, target):
    """Each conversion gives the reference's components and values (to
    1e-15 relative; epochs' days exactly)."""
    from pint_tpu_torch.binaryconvert import convert_binary

    comps, want = ref["info"]["conversions"][f"{name}->{target}"]
    out = convert_binary(get_model(PARS[name]), target)
    assert list(out.components) == comps
    got = {}
    for n, p in out.params.items():
        v = p.internal()
        if v is None or isinstance(v, (str, bool)):
            continue
        if isinstance(v, HostDD):
            v = [float(v.hi), float(v.lo)]
        elif isinstance(v, tuple) and isinstance(v[1], HostDD):
            v = [float(v[0]), float(v[1].hi), float(v[1].lo)]
        elif isinstance(v, tuple):
            v = [float(x) for x in v]
        else:
            v = [float(v)]
        got[n] = v
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_allclose(got[n][:2], want[n][:2], rtol=1e-15,
                                   atol=0.0, err_msg=n)
    if target == "DDS":
        assert out.params["SHAPMAX"].value == pytest.approx(
            -np.log(1.0 - 0.9), rel=1e-14)


# -- polycos (twins of tests/test_derived_l6.py) ---------------------------
def test_polycos_phase_matches_model():
    from pint_tpu_torch.polycos import Polycos
    from pint_tpu_torch.timebase.times import TimeArray
    from pint_tpu_torch.toas.ingest import ingest_barycentric
    from pint_tpu_torch.toas.toas import TOAs

    m = get_model(PAR)
    pcs = Polycos.generate(m, 55000.0, 55000.5, obs="@",
                           segment_minutes=60.0, ncoeff=12, device="cpu")
    assert len(pcs.entries) == 12
    rng = np.random.default_rng(3)
    mjds = 55000.0 + np.sort(rng.uniform(0.01, 0.49, 20))
    toas = TOAs(TimeArray.from_mjd_float(mjds, scale="utc"),
                np.full(20, 1400.0), np.ones(20), ["@"] * 20,
                [dict() for _ in range(20)])
    ingest_barycentric(toas)
    cm = m.compile(toas, device="cpu", subtract_mean=False)
    ph = cm.phase(cm.x0())
    ints, fracs = pcs.eval_abs_phase(mjds)
    model_total = ph.int_.numpy() + ph.frac.numpy()
    # sub-cycle agreement at the 1e-7 level (poly truncation)
    assert np.max(np.abs((ints + fracs) - model_total)) < 1e-6
    f = pcs.eval_spin_freq(mjds)
    np.testing.assert_allclose(f, 245.4261196898081, rtol=1e-9)


def test_polycos_vs_independent_oracle(ref):
    """golden1's full model (ELL1 + DM), barycentric, at off-node
    epochs, against the mpmath oracle's absolute phase within 1e-6
    cycles (the reference test's gate)."""
    from pint_tpu_torch.polycos import Polycos

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = get_model(str(DATADIR / "golden1.par"))
        pcs = Polycos.generate(m, 55100.0, 55100.5, obs="@",
                               segment_minutes=60.0, ncoeff=12,
                               obsfreq_mhz=1400.0, device="cpu")
    ints, fracs = pcs.eval_abs_phase(POLY_MJDS)
    o = ref["poly/oracle"]
    d = (ints - o[:, 0]) + (fracs - o[:, 1])
    assert np.max(np.abs(d)) < 1e-6, d


def test_polycos_write_read_roundtrip(tmp_path, ref):
    from pint_tpu_torch.polycos import Polycos

    m = get_model(PAR)
    pcs = Polycos.generate(m, 55000.0, 55000.25, obs="@", ncoeff=9,
                           device="cpu")
    path = tmp_path / "polyco.dat"
    pcs.write(path)
    pcs2 = Polycos.read(path)
    assert len(pcs2.entries) == len(pcs.entries)
    mjds = np.array([55000.05, 55000.2])
    i1, f1 = pcs.eval_abs_phase(mjds)
    i2, f2 = pcs2.eval_abs_phase(mjds)
    np.testing.assert_allclose((i1 - i2) + (f1 - f2), 0.0, atol=1e-6)
    # the reference's segments: the same TMIDs and reference phases, and
    # polynomials within 1e-9 cycles of each other over each span
    np.testing.assert_array_equal([e.tmid_mjd for e in pcs.entries],
                                  ref["poly/tmid"])
    np.testing.assert_array_equal(
        [[e.rphase_int, e.rphase_frac, e.f0] for e in pcs.entries],
        ref["poly/rphase"])
    dt = np.linspace(-30.0, 30.0, 61)
    for e, want in zip(pcs.entries, ref["poly/coeffs"]):
        gap = np.polynomial.polynomial.polyval(dt, e.coeffs - want)
        assert np.max(np.abs(gap)) < 1e-9


def test_polycos_entry_lookup():
    """``_entry_indices`` is the linear scan's answer, and an epoch off
    every segment raises."""
    from pint_tpu_torch.exceptions import PintTpuError
    from pint_tpu_torch.polycos import Polycos

    pcs = Polycos.generate(get_model(PAR), 55000.0, 55000.25, obs="@",
                           segment_minutes=30.0, ncoeff=6, device="cpu")
    mjds = np.sort(np.random.default_rng(5).uniform(55000.0, 55000.25, 97))
    idx = pcs._entry_indices(mjds)
    assert [pcs.entries[int(i)] for i in idx] == [pcs._entry_for(x)
                                                  for x in mjds]
    with pytest.raises(PintTpuError, match="outside"):
        pcs.eval_abs_phase([55001.0])


# -- make_population (tests/test_onchip_accuracy.py:497's use) --------------
def test_make_population_matches_reference(ref):
    from pint_tpu_torch.parallel.pta import PTABatch
    from pint_tpu_torch.simulation import make_population

    pars, toas = make_population(POP_PAR, 3, ntoa=40, seed=5, iterations=1,
                                 device="cpu")
    assert len(pars) == 3 and all(isinstance(p, str) for p in pars)
    np.testing.assert_array_equal(toas.t.mjd_int, ref["pop/day"])
    np.testing.assert_array_equal(toas.t.sec.hi, ref["pop/hi"])
    np.testing.assert_array_equal(toas.t.sec.lo, ref["pop/lo"])
    models = [get_model(p) for p in pars]
    for m, want in zip(models, ref["info"]["population"]):
        assert sorted(m.free_params) == sorted(want)
        for n, v in want.items():
            got = m.params[n].internal()
            got = ([float(got.hi), float(got.lo)] if isinstance(got, HostDD)
                   else [float(got)])
            np.testing.assert_allclose(got[0], v[0], rtol=1e-15, atol=0.0)
    # a variant's residuals batched with the others equal its own
    cms = [m.compile(toas, device="cpu") for m in models]
    solo = PTABatch([cms[1]] * 3)
    mix = PTABatch(cms)
    r_solo = solo.residuals(solo.x0())[0]
    r_mix = mix.residuals(mix.x0())[1]
    assert torch.equal(r_solo, r_mix)
    assert torch.equal(r_mix, cms[1].time_residuals(cms[1].x0(),
                                                    subtract_mean=False))
