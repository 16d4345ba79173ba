"""The port's error contract against the reference's.

Every raise site of the reference's model layer (the components'
``require``/``validate``, the builder, ``parameter.py`` and
``binaryconvert.py``) is one case: the same ill-formed par text, or the
same few lines of code, goes to both packages.  The port must raise the
class the reference raises, with the same ancestry (so that ``except
TimingModelError`` or ``except MissingParameter`` catches the same
errors from either package), naming the same parameter and keeping the
reference's key phrase.

The one departure, ``UNITS TCG``, is held apart: the reference reads
such a par file as TDB without a word, the port refuses it with
``TimingModelError``.

The reference runs every case once, in one subprocess
(tests/torch_reference.py).
"""

import sys
import textwrap
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import run_reference  # noqa: E402

BASE = "PSR J0\nF0 10 1\nPEPOCH 55000\n"
EQU = "RAJ 1:2:3\nDECJ 1:2:3\n"
ORBIT = "PB 0.5\nA1 3.0\nECC 0.05\nOM 10.0\nT0 55000.2\n"
ELL1 = "BINARY ELL1\nPB 0.5\nA1 3.0\nTASC 55000.2\nEPS1 0\nEPS2 0\n"
DD = "BINARY DD\n" + ORBIT

#: case -> (par text, or code run with ``pkg`` the package's name and
#: ``dev`` its device keyword; the key phrase both messages hold)
PAR_CASES = {
    # models/builder.py
    "unknown_binary": (BASE + "BINARY FOO\nPB 1\nA1 1\nTASC 55000\n",
                       "unknown binary model"),
    "mixed_astrometry": (BASE + EQU + "ELONG 12.3\nELAT 45.6\n",
                         "mixes equatorial"),
    # models/component.py::require
    "missing_f0": ("PSR J0\nF1 -1e-15\nPEPOCH 55000\n",
                   "missing parameter F0"),
    # models/spindown.py
    "spin_gap": (BASE + "F2 1e-25\n", "non-contiguous spin terms"),
    "spin_pepoch": ("PSR J0\nF0 10\nF1 -1e-15\n", "PEPOCH required"),
    # models/dispersion.py
    "dm_epoch": (BASE + "DM 10\nDM1 0.001\n", "DMEPOCH required"),
    "dm_gap": (BASE + "DM 10\nDMEPOCH 55000\nDM2 0.001\n",
               "non-contiguous DM derivatives"),
    "dmx_range": (BASE + "DM 10\nDMX_0001 0.001\n",
                  "its MJD range bounds are not"),
    # models/solar_wind.py
    "ne_sw_astrometry": (BASE + "NE_SW 7.9\n",
                         "needs an astrometry component"),
    "ne_sw_gap": (BASE + EQU + "NE_SW 7.9\nNE_SW2 0.1\nSWEPOCH 55000\n",
                  "non-contiguous solar-wind derivatives"),
    "swepoch": (BASE + EQU + "NE_SW 7.9\nNE_SW1 0.1\n",
                "missing parameter SWEPOCH"),
    "swx_astrometry": (BASE + "SWXDM_0001 1e-3\nSWXR1_0001 54000\n"
                       "SWXR2_0001 55000\n", "SWX needs an astrometry"),
    "swx_range": (BASE + EQU + "SWXDM_0001 1e-3\n",
                  "missing parameter SWXR1_0001/SWXR2_0001"),
    # models/chromatic.py
    "cm_gap": (BASE + "CM 0.01\nCMEPOCH 55000\nCM2 0.1\n",
               "non-contiguous chromatic derivatives"),
    "cmepoch": (BASE + "CM 0.01\nCM1 0.1\n", "missing parameter CMEPOCH"),
    # models/piecewise.py
    "pwep": (BASE + "PWSTART_1 54000\nPWSTOP_1 55000\nPWF0_1 1e-8\n",
             "missing parameter PWEP_1"),
    "pwstart": (BASE + "PWEP_1 54500\nPWF0_1 1e-8\n",
                "missing PWSTART/PWSTOP"),
    # models/pulsar_binary.py
    "ddh_stigma": (BASE + "BINARY DDH\n" + ORBIT + "H3 1e-7\nSTIGMA 0\n",
                   "STIGMA"),
    "ddh_h3": (BASE + "BINARY DDH\n" + ORBIT + "STIGMA 0.5\n",
               "missing parameter H3"),
    "bt_piecewise_bounds": (BASE + "BINARY BT_PIECEWISE\n" + ORBIT
                            + "T0X_0001 55000.3\nXR2_0001 55000\n",
                            "XR1/XR2"),
    "bt_piecewise_overlap": (BASE + "BINARY BT_PIECEWISE\n" + ORBIT
                             + "A1X_0001 3.1\nXR1_0001 54900\n"
                             "XR2_0001 55000\nA1X_0002 3.2\n"
                             "XR1_0002 54950\nXR2_0002 55050\n",
                             "overlap"),
    "ddk_astrometry": (BASE + "BINARY DDK\n" + ORBIT + "KIN 70\nKOM 30\n",
                       "DDK requires an astrometry component"),
    "ddk_kin": (BASE + EQU + "BINARY DDK\n" + ORBIT + "KOM 30\n",
                "missing parameter KIN"),
    # models/parameter.py (maskParameter.set_from_tokens, s_to_bool)
    "mask_key": (BASE + "JUMP bogus 1\n", "cannot parse mask parameter"),
    "bool_value": (BASE + EQU + "PLANET_SHAPIRO maybe\n",
                   "cannot parse bool"),
}

_TOAS = ("from {pkg}.simulation import make_test_pulsar\n"
         f"model, toas = make_test_pulsar({BASE + 'DM 10 1' + chr(10)!r}, "
         "ntoa=16{dev})\n")

CODE_CASES = {
    # models/glitch.py: a glitch whose epoch was never set
    "glitch_glep": ("from {pkg}.models.glitch import Glitch\n"
                    "g = Glitch()\ng.add_glitch(1)\ng.validate(None)\n",
                    "missing parameter GLEP_1"),
    # models/parameter.py
    "mjd_set_internal": ("from {pkg}.models.parameter import MJDParameter\n"
                         "MJDParameter('PEPOCH').set_internal(1.0)\n",
                         "add_internal_delta"),
    "prefix_name": ("from {pkg}.models.parameter import "
                    "split_prefixed_name\nsplit_prefixed_name('F')\n",
                    "is not a prefixed parameter name"),
    "s_to_bool": ("from {pkg}.models.parameter import s_to_bool\n"
                  "s_to_bool('maybe')\n", "cannot parse bool"),
    # models/timing_model.py
    "duplicate_component": ("from {pkg}.models.timing_model import "
                            "TimingModel\n"
                            "from {pkg}.models.spindown import Spindown\n"
                            "m = TimingModel(components=[Spindown()])\n"
                            "m.add_component(Spindown())\n",
                            "duplicate component Spindown"),
    "not_free": (_TOAS + "model.d_phase_d_param(toas, 'PEPOCH'{dev})\n",
                 "PEPOCH is not a free parameter"),
    "no_spindown": (_TOAS + "from {pkg}.models.builder import get_model\n"
                    "cm = get_model('PSR J0\\nDM 10 1\\n').compile("
                    "toas{dev})\ncm.spin_frequency(cm.x0())\n",
                    "no spindown component"),
    "no_wideband_dm": (_TOAS + "cm = model.compile(toas{dev})\n"
                       "cm.dm_residuals(cm.x0())\n",
                       "no wideband DM measurements"),
    # binaryconvert.py
    "convert_no_binary": ("from {pkg}.models.builder import get_model\n"
                          "from {pkg}.binaryconvert import convert_binary\n"
                          f"convert_binary(get_model({BASE!r}), 'DD')\n",
                          "model has no binary component"),
    "convert_eps_dot": ("from {pkg}.models.builder import get_model\n"
                        "from {pkg}.binaryconvert import convert_binary\n"
                        "convert_binary(get_model("
                        f"{BASE + ELL1 + 'EPS1DOT 1e-12' + chr(10)!r}), "
                        "'DD')\n", "zero eccentricity"),
    "convert_ecc": ("from {pkg}.models.builder import get_model\n"
                    "from {pkg}.binaryconvert import convert_binary\n"
                    "convert_binary(get_model("
                    f"{BASE + DD.replace('0.05', '0.1')!r}), 'ELL1')\n",
                    "the ELL1 expansion needs e << 1"),
    "convert_gamma": ("from {pkg}.models.builder import get_model\n"
                      "from {pkg}.binaryconvert import convert_binary\n"
                      "convert_binary(get_model("
                      f"{BASE + DD + 'GAMMA 1e-4' + chr(10)!r}), 'ELL1')\n",
                      "ELL1 cannot represent GAMMA"),
    "convert_sini": ("from {pkg}.models.builder import get_model\n"
                     "from {pkg}.binaryconvert import convert_binary\n"
                     f"convert_binary(get_model({BASE + DD!r}), 'DDS')\n",
                     "DD->DDS needs 0 < SINI < 1"),
    "convert_unsupported": ("from {pkg}.models.builder import get_model\n"
                            "from {pkg}.binaryconvert import convert_binary\n"
                            f"convert_binary(get_model({BASE + ELL1!r}), "
                            "'DDK')\n", "not supported"),
}

CASES = {**{k: (f"from {{pkg}}.models.builder import get_model\n"
                f"get_model({par!r})\n", phrase)
            for k, (par, phrase) in PAR_CASES.items()},
         **CODE_CASES}

TCG_PAR = BASE + "UNITS TCG\n"


def _outcome(code: str, pkg: str, dev: str) -> dict:
    """What running ``code`` raised: class, ancestry, message, and the
    ``module``/``param`` of a MissingParameter."""
    import warnings

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            exec(code.format(pkg=pkg, dev=dev), {})
    except Exception as e:  # noqa: BLE001 - the contract under test
        return dict(cls=type(e).__name__,
                    mro=[c.__name__ for c in type(e).__mro__],
                    msg=str(e), module=getattr(e, "module", None),
                    param=getattr(e, "param", None))
    return dict(cls=None, mro=[], msg="", module=None, param=None)


_SCRIPT = textwrap.dedent(f"""
import warnings
from test_torch_contract import CASES, TCG_PAR, _outcome
for name, (code, _) in CASES.items():
    META[name] = _outcome(code, "pint_tpu", "")
from pint_tpu.models.builder import get_model
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    m = get_model(TCG_PAR)
OUT["tcg/built"] = np.array(type(m).__name__)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("contract")
    return run_reference(_SCRIPT, d / "contract.npz", timeout=600)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_raises_the_reference_class(ref, name):
    """The port's exception: the reference's class and ancestry, the
    same MissingParameter module and parameter, and the reference's key
    phrase in both messages."""
    code, phrase = CASES[name]
    want = ref["__meta__"][name]
    got = _outcome(code, "pint_tpu_torch", ", device='cpu'")
    assert want["cls"] is not None, f"the reference raised nothing: {name}"
    assert got["cls"] == want["cls"], (got, want)
    assert got["mro"] == want["mro"], (got["mro"], want["mro"])
    assert (got["module"], got["param"]) == (want["module"], want["param"])
    assert phrase in want["msg"], want["msg"]
    assert phrase in got["msg"], got["msg"]


def test_units_tcg_is_refused_where_the_reference_reads_tdb(ref):
    """The logged departure: the reference builds a ``UNITS TCG`` par
    file as if it were TDB; the port refuses it, with the reference's
    model-error class."""
    from pint_tpu_torch.exceptions import PintTpuError, TimingModelError
    from pint_tpu_torch.models.builder import get_model

    assert str(ref["tcg/built"]) == "TimingModel"
    with pytest.raises(TimingModelError, match="TCG") as ei:
        get_model(TCG_PAR)
    assert isinstance(ei.value, PintTpuError)
    assert not isinstance(ei.value, ValueError)


def test_every_reference_exception_name_is_in_the_port():
    """Every class ``pint_tpu/exceptions.py`` defines can be imported
    from ``pint_tpu_torch.exceptions``, with the same bases by name."""
    import ast

    import pint_tpu_torch.exceptions as port

    tree = ast.parse((Path(__file__).parent.parent / "pint_tpu"
                      / "exceptions.py").read_text())
    classes = {n.name: [b.id for b in n.bases]
               for n in tree.body if isinstance(n, ast.ClassDef)}
    for name, bases in classes.items():
        cls = getattr(port, name)
        assert [b.__name__ for b in cls.__bases__] == bases, name
