"""Twins of the reference's model-builder tests.

One twin for each test of ``tests/test_builder.py`` (component choice,
routing, aliases, the BINARY line, mixed astrometry, unknown lines, the
par round trip, indexed families past the preallocated ones, the parse
cache and DMX routing) and for the three raise tests of
``tests/test_components_new.py:205-251`` (BT_PIECEWISE bounds and
overlap, DDH with STIGMA 0).  Each runs the port through
``ModelBuilder``/``get_model`` with the reference test's inputs and
assertions and holds what both packages built against each other: the
components (``ModelBuilder.choose_components``), the routed values and
the par text.  The parse cache's knobs are the port's own
(``PINT_TPU_TORCH_PARSE_CACHE``, ``PINT_TPU_TORCH_PARSE_CACHE_SIZE``).

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

from pint_tpu_torch.exceptions import TimingModelError  # noqa: E402
from pint_tpu_torch.io.par import parse_parfile  # noqa: E402
from pint_tpu_torch.models.builder import (  # noqa: E402
    ModelBuilder,
    UnknownParameterWarning,
    clear_parse_cache,
    get_model,
)
from pint_tpu_torch.obs import metrics as obs_metrics  # noqa: E402

PAR = """
PSRJ            J1857+0943
RAJ             18:57:36.3932884
DECJ            +09:43:17.29196
PMRA            -2.899
PMDEC           -5.41
PX              0.2629
POSEPOCH        55637
F0              186.49408156698235146  1  0.0000000000000698912
F1              -6.2049e-16            1
PEPOCH          55637
DM              13.299393
DM1             0.0001
DMEPOCH         55637
BINARY          ELL1
PB              12.32717119132762      1
A1              9.2307805              1
TASC            55631.710921           1
EPS1            -2.15e-05              1
EPS2            1.2e-05                1
SINI            0.9990
M2              0.246
JUMP            -fe L-wide 0.00032    1
JUMP            mjd 55000 56000 1.5e-5
EPHEM           DE440
CLOCK           TT(BIPM2021)
UNITS           TDB
"""
ALIAS_PAR = PAR.replace("A1 ", "X  ").replace("ECC", "E")
PREFIX_PAR = "PSR J0\nF0 10 1\nPEPOCH 55000\n" + "\n".join(
    f"F{k} 1e-{20 + k}" for k in range(1, 15))
DMX_PAR = (
    "PSR J0\nF0 10 1\nPEPOCH 55000\nDM 10\n"
    "DMX_0001 0.001 1\nDMXR1_0001 54000\nDMXR2_0001 54500\n"
    "DMX_0002 -0.002 1\nDMXR1_0002 54500\nDMXR2_0002 55000\n"
)
UNKNOWN_PAR = "PSR J0\nF0 10\nPEPOCH 55000\nNOTAPARAM 12\n"
COMP_BASE = """
PSR              J0000+0000
F0               300.0              1
F1               -1e-15
PEPOCH           55000
DM               10.0
"""
BT_PIECE = COMP_BASE + """
BINARY           BT_PIECEWISE
PB               0.5
A1               3.0
ECC              0.05
OM               10.0
T0               55000.2
"""
BT_BOUNDS = BT_PIECE + "T0X_0001         55000.3\nXR2_0001         55000\n"
BT_OVERLAP = BT_PIECE + """
A1X_0001         3.1
XR1_0001         54900
XR2_0001         55000
A1X_0002         3.2
XR1_0002         54950
XR2_0002         55050
"""
DDH_STIGMA = COMP_BASE + """
BINARY           DDH
PB               0.3
A1               2.0
ECC              0.12
OM               70.0
T0               55000.1
H3 1e-7
STIGMA 0
"""
#: the par texts whose models both packages build
BUILT = {"par": PAR, "alias": ALIAS_PAR, "prefix": PREFIX_PAR,
         "dmx": DMX_PAR, "unknown": UNKNOWN_PAR}
#: the ones both refuse, with the reference's key phrase
REFUSED = {
    "binary_foo": ("PSR J0\nF0 10 1\nBINARY FOO\nPB 1\nA1 1\nTASC 55000\n",
                   "unknown binary model"),
    "mixed_astrometry": ("PSR J0\nF0 10\nPEPOCH 55000\nRAJ 1:2:3\n"
                         "DECJ 1:2:3\nELONG 12.3\nELAT 45.6\n",
                         "mixes equatorial"),
    "bt_piecewise_bounds": (BT_BOUNDS, "XR1/XR2"),
    "bt_piecewise_overlap": (BT_OVERLAP, "overlap"),
    "ddh_stigma_zero": (DDH_STIGMA, "STIGMA"),
}


def _summary(m) -> dict:
    """What the twins compare: the components in order, each set
    parameter's value as a float (epochs as MJD, pairs and strings as
    text), the free ones and the unrecognized lines."""
    vals = {}
    for n, p in m.params.items():
        v = p.value
        if v is None:
            continue
        if hasattr(v, "to_float"):
            v = float(np.asarray(v.to_float()).reshape(-1)[0])
        elif isinstance(v, tuple):
            v = float(v[0] + float(v[1]) / 86400.0)
        elif hasattr(v, "mjd_float"):
            v = float(v.mjd_float()[0])
        elif isinstance(v, (bool, str)):
            v = str(v)
        vals[n] = v
    return dict(components=list(m.components), values=vals,
                free=list(m.free_params), unrecognized=sorted(m.unrecognized))


_SCRIPT = textwrap.dedent("""
import warnings
from test_torch_builder import BUILT, REFUSED, _summary
from pint_tpu.io.par import parse_parfile
from pint_tpu.models.builder import ModelBuilder, get_model
for key, par in BUILT.items():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = ModelBuilder()(par)
        META[key] = _summary(m)
        META[key]["chosen"] = [type(c).__name__ for c in
                               ModelBuilder().choose_components(
                                   parse_parfile(par))]
        META[key]["roundtrip"] = _summary(get_model(m.as_parfile()))
for key, (par, _) in REFUSED.items():
    try:
        ModelBuilder()(par)
        META[key] = None
    except Exception as e:
        META[key] = dict(cls=type(e).__name__, msg=str(e))
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("builder")
    return run_reference(_SCRIPT, d / "builder.npz", timeout=600)["__meta__"]


def _same_values(got: dict, want: dict, rtol=1e-15):
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        g = got[n]
        if isinstance(w, str):
            assert g == w, n
        else:
            assert g == pytest.approx(w, rel=rtol, abs=1e-300), n


def _build(par):
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UnknownParameterWarning)
        return ModelBuilder()(par)


def test_component_selection(ref):
    m = get_model(PAR)
    names = set(m.components)
    assert {
        "AstrometryEquatorial", "Spindown", "DispersionDM",
        "BinaryELL1", "PhaseJump", "SolarSystemShapiro",
    } <= names
    assert "AstrometryEcliptic" not in names
    assert "DispersionDMX" not in names
    chosen = ModelBuilder().choose_components(parse_parfile(PAR))
    assert [type(c).__name__ for c in chosen] == ref["par"]["chosen"]
    assert list(m.components) == ref["par"]["components"]


def test_param_routing_and_values(ref):
    m = get_model(PAR)
    assert m.params["PSR"].value == "J1857+0943"
    assert not m.params["F0"].frozen
    assert m.params["F0"].uncertainty == pytest.approx(6.98912e-14)
    assert m.params["PMRA"].value == pytest.approx(-2.899)
    # mask params: two JUMPs with distinct selections
    assert m.params["JUMP1"].key == "-fe"
    assert m.params["JUMP1"].key_value == ["L-wide"]
    assert not m.params["JUMP1"].frozen
    assert m.params["JUMP2"].key == "mjd"
    assert m.params["JUMP2"].value == pytest.approx(1.5e-5)
    assert m.params["M2"].value == pytest.approx(0.246)
    assert m.top_params["EPHEM"].value == "DE440"
    got = _summary(m)
    _same_values(got["values"], ref["par"]["values"])
    assert got["free"] == ref["par"]["free"]


def test_alias_routing(ref):
    m = get_model(ALIAS_PAR)
    assert m.params["A1"].value == pytest.approx(9.2307805)
    _same_values(_summary(m)["values"], ref["alias"]["values"])


def test_binary_required_for_binary_params(ref):
    par, phrase = REFUSED["binary_foo"]
    with pytest.raises(TimingModelError, match=phrase):
        get_model(par)
    assert ref["binary_foo"]["cls"] == "TimingModelError"


def test_mixed_astrometry_rejected(ref):
    par, phrase = REFUSED["mixed_astrometry"]
    with pytest.raises(TimingModelError, match=phrase):
        get_model(par)
    assert ref["mixed_astrometry"]["cls"] == "TimingModelError"


def test_unknown_params_warn(ref):
    clear_parse_cache()
    with pytest.warns(UnknownParameterWarning):
        m = get_model(UNKNOWN_PAR)
    assert "NOTAPARAM" in m.unrecognized
    assert sorted(m.unrecognized) == ref["unknown"]["unrecognized"]


def test_parfile_round_trip(ref):
    m = get_model(PAR)
    text = m.as_parfile()
    m2 = get_model(text)
    for n in ("F0", "PB", "A1", "EPS1", "PMRA", "M2"):
        v1, v2 = m.params[n].value, m2.params[n].value
        if hasattr(v1, "to_float"):
            v1, v2 = float(v1.to_float()), float(v2.to_float())
        assert v1 == pytest.approx(v2, rel=1e-12), n
    assert m2.params["JUMP1"].key == "-fe"
    assert set(m.components) == set(m2.components)
    got = _summary(m2)
    assert got["components"] == ref["par"]["roundtrip"]["components"]
    _same_values(got["values"], ref["par"]["roundtrip"]["values"],
                 rtol=1e-12)


def test_prefix_param_beyond_preallocated(ref):
    m = get_model(PREFIX_PAR)
    assert m.params["F14"].value == pytest.approx(1e-34)
    _same_values(_summary(m)["values"], ref["prefix"]["values"])


# -- the parse cache, with the port's knobs ------------------------------
def _parses():
    return obs_metrics.counter("model.parses").value


def _f0(m):
    v = m.params["F0"].value
    return float(v.to_float()) if hasattr(v, "to_float") else float(v)


def test_parse_cache_hit_skips_parse_and_isolates():
    clear_parse_cache()
    par = PAR.replace("J1857+0943", "J1857+0001")
    p0 = _parses()
    h0 = obs_metrics.counter("model.parse_cache_hits").value
    m1 = get_model(par)
    m2 = get_model(par)
    assert _parses() == p0 + 1
    assert obs_metrics.counter("model.parse_cache_hits").value == h0 + 1
    assert m2 is not m1
    assert m1.as_parfile() == m2.as_parfile()
    assert set(m1.components) == set(m2.components)
    assert m2.params["JUMP1"].key == "-fe"
    f0 = _f0(m1)
    m2.params["F0"].value = 1.0
    m3 = get_model(par)
    assert _f0(m3) == pytest.approx(f0)


def test_parse_cache_env_disable(monkeypatch):
    monkeypatch.setenv("PINT_TPU_TORCH_PARSE_CACHE", "0")
    clear_parse_cache()
    par = PAR.replace("J1857+0943", "J1857+0002")
    p0 = _parses()
    get_model(par)
    get_model(par)
    assert _parses() == p0 + 2


def test_parse_cache_replays_parse_warnings():
    clear_parse_cache()
    with pytest.warns(UnknownParameterWarning):
        m1 = get_model(UNKNOWN_PAR)
    with pytest.warns(UnknownParameterWarning):
        m2 = get_model(UNKNOWN_PAR)  # replayed from the cache hit
    assert "NOTAPARAM" in m1.unrecognized
    assert "NOTAPARAM" in m2.unrecognized


def test_parse_cache_ignores_paths(tmp_path):
    clear_parse_cache()
    f = tmp_path / "a.par"
    f.write_text("PSR J0\nF0 10 1\nPEPOCH 55000\n")
    p0 = _parses()
    get_model(str(f))
    get_model(str(f))
    assert _parses() == p0 + 2


def test_parse_cache_lru_bound(monkeypatch):
    monkeypatch.setenv("PINT_TPU_TORCH_PARSE_CACHE_SIZE", "2")
    clear_parse_cache()
    pars = [f"PSR J000{i}\nF0 10 1\nPEPOCH 55000\n" for i in range(3)]
    for p in pars:
        get_model(p)
    p0 = _parses()
    get_model(pars[0])  # evicted by pars[2]: parsed again
    assert _parses() == p0 + 1
    get_model(pars[2])  # still resident: a hit
    assert _parses() == p0 + 1


def test_dmx_routing(ref):
    m = get_model(DMX_PAR)
    assert "DispersionDMX" in m.components
    c = m.components["DispersionDMX"]
    assert c.dmx_indices == [1, 2]
    assert m.params["DMX_0002"].value == pytest.approx(-0.002)
    _same_values(_summary(m)["values"], ref["dmx"]["values"])
    assert _summary(m)["free"] == ref["dmx"]["free"]


# -- tests/test_components_new.py:205-251 ---------------------------------
@pytest.mark.parametrize("key", ["bt_piecewise_bounds",
                                 "bt_piecewise_overlap", "ddh_stigma_zero"])
def test_component_validation_raises(ref, key):
    par, phrase = REFUSED[key]
    with pytest.raises(TimingModelError, match=phrase):
        get_model(par)
    assert ref[key]["cls"] == "TimingModelError"
    assert phrase in ref[key]["msg"]


# -- ModelBuilder itself ---------------------------------------------------
@pytest.mark.parametrize("key", sorted(BUILT))
def test_model_builder_matches_the_reference(ref, key):
    """``ModelBuilder()(par)`` builds the reference's model (components,
    values, free parameters, unrecognized lines) and ``get_model`` the
    same par text as it."""
    par = BUILT[key]
    m = _build(par)
    got = _summary(m)
    assert got["components"] == ref[key]["components"]
    assert got["free"] == ref[key]["free"]
    assert got["unrecognized"] == ref[key]["unrecognized"]
    _same_values(got["values"], ref[key]["values"])
    chosen = ModelBuilder().choose_components(parse_parfile(par))
    assert [type(c).__name__ for c in chosen] == ref[key]["chosen"]
    clear_parse_cache()
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UnknownParameterWarning)
        assert get_model(par).as_parfile() == m.as_parfile()
