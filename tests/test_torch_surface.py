"""The port's last public names, each held against its reference twin.

- The functions that nothing else holds against the reference:
  ``derived_quantities`` (``pulsar_B_lightcyl``, ``pulsar_mass``,
  ``sini_gr``, ``shklovskii_factor``, ``dispersion_slope``,
  ``pb_from_fb0``), ``fitting/utils.py`` (``akaike_information_criterion``,
  ``parameter_correlation_matrix``), ``event_toas.load_fermi_TOAs``,
  ``earth/eop.py::set_eop_table`` and ``parallel/mesh.py``'s
  ``pad_bundle`` and ``shard_rows`` (rank i of 8 against device i's
  shard of the reference's ``NamedSharding`` over its virtual 8-device
  CPU mesh).
- The names the port gained to match the reference's surface:
  ``intParameter``, ``s_to_bool``, ``prefixParameter``,
  ``funcParameter``, ``Parameter.quantity``,
  ``maskParameter.name_no_index``, ``io/par.py::parfile_dict_to_text``,
  ``DispersionDMX.dmx_masks``, ``TimingModel.has_tzr_anchor``,
  ``ops/dd.py``'s ``dd_abs``, ``DD.reshape``, ``DD.sum`` and
  ``DD.from_string``, ``timebase/tdb.py::tdb_minus_tt_mjd``,
  ``TimeArray.from_mjd_two_part``, ``HostDD.to_device`` and
  ``HostDD.split_int_frac``.
- The public names of both packages (module functions and classes, and
  the methods of classes): each of the reference's has a counterpart in
  the port, but for the JAX-only names of ``JAX_ONLY``.

Each twin feeds both packages the same inputs and wants the same
outputs, bit for bit (host numpy, or the DD transforms on the CPU).  The
reference runs once for the module in a subprocess
(tests/torch_reference.py).
"""

import ast
import importlib
import pkgutil
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import dd_inputs, run_reference  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FINALS = REPO / "tests" / "datafile" / "ingest" / "finals_mini.all"

#: the reference's public names with no counterpart, each JAX-only: why
#: is in ROADMAP.md (queue A)
JAX_ONLY = {
    "CompiledModel.jit", "CompiledModel.chi2_jit",
    "CompiledModel.design_matrix_jit", "CompiledModel.time_residuals_jit",
    "split_ref_runtime", "make_scan_fit_loop", "traced_jit",
    "serve_donate_argnums", "donation_enabled", "quiet_unusable_donation",
    "snapshot_donated", "ladder_device", "cache_dir", "entry_count",
}

#: the inputs of the derived-quantity twins (host floats and arrays)
DERIVED = {
    "pulsar_B_lightcyl": ([339.31568732647, 29.946923],
                          [-1.6148e-15, -3.77535e-10]),
    "pulsar_mass": ([1.533449474406 * 86400, 67.825 * 86400],
                    [1.89799106, 32.342422], [0.2, 0.28], [1.48, 1.25]),
    "sini_gr": ([1.4, 1.33], [0.2, 0.29], [1.533449474406 * 86400,
                                           67.825 * 86400],
                [1.89799106, 32.342422]),
    "shklovskii_factor": ([1.7e-15, 2.3e-16], [1.16, 0.86]),
    "dispersion_slope": ([10.3931, 15.99],),
    "pb_from_fb0": ([7.547e-6, 1.7064e-7],),
}
EPOCH_PAR = ("PSR J0\nF0 10 1\nPEPOCH 55000\nDM 10\n"
             "DMX_0001 0.001 1\nDMXR1_0001 54000\nDMXR2_0001 54500.25\n"
             "DMX_0002 -0.002 1\nDMXR1_0002 54500.5\nDMXR2_0002 55000\n"
             "JUMP -f L-wide 1e-6 1\nJUMP mjd 54200 54300 2e-6\n")
TZR_PAR = EPOCH_PAR + "TZRMJD 55000.1\nTZRSITE @\nTZRFRQ 1400\n"
#: the rows of the padded bundle (not a multiple of the 8 shards)
PAD_NTOA = 61


def epoch_mjds():
    return np.linspace(54000.0, 55000.0, 41)


def event_columns():
    rng = np.random.default_rng(11)
    met = rng.uniform(0.0, 5e7, 300)
    return ({"TIME": met, "WEIGHT": rng.uniform(0, 1, 300),
             "ENERGY": rng.uniform(100, 3e5, 300)},
            {"MJDREFI": 51910, "MJDREFF": 7.428703703703703e-4,
             "TIMEZERO": 1.5, "TIMESYS": "TT", "TELESCOP": "GLAST"})


def cov_input():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((6, 6))
    cov = a @ a.T
    cov[4, :] = cov[:, 4] = 0.0  # an unconstrained parameter
    return cov


_SCRIPT = textwrap.dedent(f"""
import warnings
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from torch_reference import dd_inputs
from test_torch_surface import (DERIVED, EPOCH_PAR, FINALS, PAD_NTOA,
                                TZR_PAR, cov_input, epoch_mjds,
                                event_columns)
import pint_tpu.derived_quantities as dq
from pint_tpu.earth import eop
from pint_tpu.event_toas import load_fermi_TOAs
from pint_tpu.fitting.utils import (akaike_information_criterion,
                                    parameter_correlation_matrix)
from pint_tpu.io.fits import write_event_fits
from pint_tpu.io.par import parfile_dict_to_text, parse_parfile
from pint_tpu.models.builder import get_model
from pint_tpu.models.parameter import (floatParameter, funcParameter,
                                       intParameter, prefixParameter,
                                       s_to_bool)
from pint_tpu.ops.dd import DD, dd_abs
from pint_tpu.ops.tdb import tdb_minus_tt_mjd
from pint_tpu.parallel.mesh import pad_bundle
from pint_tpu.simulation import make_test_pulsar
from pint_tpu.timebase.hostdd import HostDD
from pint_tpu.timebase.times import TimeArray
from pint_tpu.toas.ingest import ingest_barycentric
from pint_tpu.toas.toas import TOAs

for name, args in DERIVED.items():
    OUT[f"derived/{{name}}"] = getattr(dq, name)(
        *[np.asarray(a, float) for a in args])
OUT["aic"] = np.array(akaike_information_criterion(812.25, 17))
OUT["corr"] = parameter_correlation_matrix(cov_input())

cols, hdr = event_columns()
write_event_fits(os.environ["EVENTS"], cols, header_extra=hdr)
ev = load_fermi_TOAs(os.environ["EVENTS"], weightcol="WEIGHT",
                     energycol="ENERGY")
OUT["fermi/day"] = ev.t.mjd_int
OUT["fermi/hi"] = ev.t.sec.hi
OUT["fermi/lo"] = ev.t.sec.lo
OUT["fermi/scale"] = np.array(ev.t.scale)
OUT["fermi/obs"] = np.array(ev.obs)
OUT["fermi/weight"] = np.array([float(f["weight"]) for f in ev.flags])
OUT["fermi/energy"] = np.array([float(f["energy"]) for f in ev.flags])

mjd = np.linspace(54400.5, 55999.5, 97)
eop.reset_eop()
eop.set_eop_table(eop.parse_finals2000a(str(FINALS)))
for k, v in zip(("dut1", "xp", "yp"), eop.get_eop(mjd)):
    OUT[f"eop/{{k}}"] = np.asarray(v)
eop.set_eop_table(None)
eop.reset_eop()

# the padded bundle, and each of 8 devices' rows of it
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    model, toas = make_test_pulsar(EPOCH_PAR, ntoa=PAD_NTOA, seed=2)
cm = model.compile(toas)
export_state(cm, "pad")
padded, valid = pad_bundle(cm.bundle, 8)
OUT["pad/valid"] = np.asarray(valid)
OUT["pad/freq"] = np.asarray(padded.freq_mhz)
OUT["pad/day"] = np.asarray(padded.tdb_day)
OUT["pad/hi"] = np.asarray(padded.tdb_sec.hi)
OUT["pad/lo"] = np.asarray(padded.tdb_sec.lo)
OUT["pad/pos"] = np.asarray(padded.ssb_obs_pos_ls)
for k, v in padded.masks.items():
    OUT[f"pad/mask/{{k}}"] = np.asarray(v)
mesh = Mesh(np.array(jax.devices()[:8]), ("toa",))
arr = jax.device_put(padded.freq_mhz, NamedSharding(mesh, P("toa")))
shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start)
OUT["shard/count"] = np.array(len(shards))
for i, s in enumerate(shards):
    OUT[f"shard/{{i}}"] = np.asarray(s.data)

# parameters
ip = intParameter("NHARM")
ip.set_from_tokens(["30.0"])
OUT["int/value"] = np.array(ip.value)
OUT["int/internal"] = np.array(ip.internal())
OUT["int/line"] = np.array(ip.as_parfile_line())
OUT["bool"] = np.array([s_to_bool(s) for s in
                        ("y", "YES", "t", "True", "1", "n", "No", "F",
                         "false", " 0 ")])
fam = prefixParameter("DMX_", index_format="04d",
                      template=lambda n: floatParameter(n, units="pc/cm^3"))
OUT["prefix/match"] = np.array([-1 if fam.match(n) is None else fam.match(n)
                                for n in ("DMX_0017", "dmx_3", "DMX_",
                                          "DMXR1_0001", "F2")])
inst = fam.instance(17)
OUT["prefix/name"] = np.array(inst.name)
OUT["prefix/index"] = np.array(inst.index)
m = get_model(EPOCH_PAR)
fp = funcParameter("DMSUM", func=lambda a, b: a + b,
                   params=("DMX_0001", "DMX_0002"))
OUT["func/value"] = np.array(fp.evaluate(m))
OUT["func/none"] = np.array(funcParameter(
    "X", func=lambda a: a, params=("F1",)).evaluate(m) is None)
OUT["func/line"] = np.array(fp.as_parfile_line())
OUT["quantity/DMX_0002"] = np.array(m.params["DMX_0002"].quantity)
OUT["quantity/JUMP1"] = np.array(m.params["JUMP1"].quantity)
OUT["name_no_index"] = np.array([m.params[n].name_no_index
                                 for n in ("JUMP1", "JUMP2")])
OUT["par_text"] = np.array(parfile_dict_to_text(parse_parfile(EPOCH_PAR)))
t = TimeArray.from_mjd_float(epoch_mjds(), scale="utc")
et = TOAs(t, np.full(t.mjd_int.shape, 1400.0), np.ones(t.mjd_int.shape),
          ["@"] * len(t.mjd_int))
ingest_barycentric(et)
for k, v in m.components["DispersionDMX"].dmx_masks(et).items():
    OUT[f"dmx_masks/{{k}}"] = v
OUT["tzr"] = np.array([get_model(EPOCH_PAR).has_tzr_anchor(),
                       get_model(TZR_PAR).has_tzr_anchor()])

# double-double and time helpers
a, la, b, lb = dd_inputs()
x = DD(jnp.asarray(a * np.sign(b)), jnp.asarray(la * np.sign(b)))
for k, v in (("abs", dd_abs(x)), ("reshape", x.reshape(8, 8)),
             ("sum_all", x.sum()), ("sum0", x.reshape(8, 8).sum(0)),
             ("sum1", x.reshape(8, 8).sum(axis=1)),
             ("string", DD.from_string("339.315687326475123456789012345"))):
    OUT[f"dd/{{k}}/hi"] = np.asarray(v.hi)
    OUT[f"dd/{{k}}/lo"] = np.asarray(v.lo)
days = np.array([51544, 55000, 58849])
secs = np.array([43200.0, 1234.5678, 86399.9])
OUT["tdb_mjd"] = np.asarray(tdb_minus_tt_mjd(days, secs))
ta = TimeArray.from_mjd_two_part(55000, 4321.125, scale="tt")
OUT["two_part"] = np.array([ta.mjd_int[0], ta.sec.hi[0], ta.sec.lo[0]])
OUT["two_part/scale"] = np.array(ta.scale)
h = HostDD(np.array([1.5, -2.25e8, 7.0]), np.array([1e-17, 3e-9, -2e-16]))
d = h.to_device()
OUT["to_device"] = np.stack([np.asarray(d.hi), np.asarray(d.lo)])
ip_, fr = HostDD(a, la).split_int_frac()
OUT["split/int"] = np.asarray(ip_)
OUT["split/frac"] = np.asarray(fr)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("surface")
    return run_reference(_SCRIPT, d / "surface.npz", timeout=600,
                         env={"EVENTS": str(d / "events.fits")})


# -- the functions nothing else held against the reference -----------------
@pytest.mark.parametrize("name", sorted(DERIVED))
def test_derived_quantity(ref, name):
    import pint_tpu_torch.derived_quantities as dq

    got = getattr(dq, name)(*[np.asarray(a, float) for a in DERIVED[name]])
    assert np.array_equal(np.asarray(got), ref[f"derived/{name}"])


def test_akaike_information_criterion(ref):
    from pint_tpu_torch.fitting.utils import akaike_information_criterion

    assert akaike_information_criterion(812.25, 17) == float(ref["aic"])


def test_parameter_correlation_matrix(ref):
    from pint_tpu_torch.fitting.utils import parameter_correlation_matrix

    got = parameter_correlation_matrix(cov_input())
    assert np.array_equal(got, ref["corr"])
    assert np.all(np.isfinite(got)) and got[4, 4] == 0.0


def test_load_fermi_toas(ref, tmp_path):
    from pint_tpu_torch.event_toas import load_fermi_TOAs
    from pint_tpu_torch.io.fits import write_event_fits

    cols, hdr = event_columns()
    path = tmp_path / "events.fits"
    write_event_fits(str(path), cols, header_extra=hdr)
    ev = load_fermi_TOAs(str(path), weightcol="WEIGHT", energycol="ENERGY")
    assert np.array_equal(ev.t.mjd_int, ref["fermi/day"])
    assert np.array_equal(ev.t.sec.hi, ref["fermi/hi"])
    assert np.array_equal(ev.t.sec.lo, ref["fermi/lo"])
    assert ev.t.scale == str(ref["fermi/scale"])
    assert list(ev.obs) == list(ref["fermi/obs"])
    assert np.array_equal([float(f["weight"]) for f in ev.flags],
                          ref["fermi/weight"])
    assert np.array_equal([float(f["energy"]) for f in ev.flags],
                          ref["fermi/energy"])


def test_set_eop_table(ref):
    from pint_tpu_torch.earth import eop

    mjd = np.linspace(54400.5, 55999.5, 97)
    eop.reset_eop()
    try:
        eop.set_eop_table(eop.parse_finals2000a(str(FINALS)))
        for k, v in zip(("dut1", "xp", "yp"), eop.get_eop(mjd)):
            assert np.array_equal(np.asarray(v), ref[f"eop/{k}"]), k
        eop.set_eop_table(None)
        assert eop._table is None
    finally:
        eop.reset_eop()


@pytest.fixture(scope="module")
def pad_state(ref):
    from pint_tpu_torch.convert import state_from_numpy
    from torch_reference import load_state

    model, bundle, _ = state_from_numpy(load_state(ref, "pad"), device="cpu")
    return model, bundle


def test_pad_bundle(ref, pad_state):
    from pint_tpu_torch.parallel.mesh import pad_bundle

    model, bundle = pad_state
    padded, valid = pad_bundle(bundle, 8)
    assert padded.ntoa == 64 and bundle.ntoa == PAD_NTOA
    assert np.array_equal(valid, ref["pad/valid"])
    for key, got in (("freq", padded.freq_mhz), ("day", padded.tdb_day),
                     ("hi", padded.tdb_sec.hi), ("lo", padded.tdb_sec.lo),
                     ("pos", padded.ssb_obs_pos_ls)):
        assert np.array_equal(got.numpy(), ref[f"pad/{key}"]), key
    for k in ("JUMP1", "JUMP2"):
        assert np.array_equal(padded.masks[k].numpy(), ref[f"pad/mask/{k}"])
    # the port's DMX range matrix: the reference's per-range masks
    dmx = model.components["DispersionDMX"].mask_key
    assert np.array_equal(padded.masks[dmx].numpy(), np.stack(
        [ref["pad/mask/DMX_0001"], ref["pad/mask/DMX_0002"]], axis=1))


def test_shard_rows(ref, pad_state, monkeypatch):
    """Rank i of an 8-way ``toa`` axis holds the rows that the
    reference's NamedSharding puts on device i."""
    from pint_tpu_torch.parallel import mesh as mesh_mod
    from pint_tpu_torch.parallel.mesh import pad_bundle, shard_rows

    padded, _ = pad_bundle(pad_state[1], 8)
    assert int(ref["shard/count"]) == 8
    monkeypatch.setattr(mesh_mod, "axis_size", lambda mesh, axis: 8)
    for i in range(8):
        monkeypatch.setattr(mesh_mod, "axis_index",
                            lambda mesh, axis, i=i: i)
        got = shard_rows(padded.freq_mhz, None)
        assert np.array_equal(got.numpy(), ref[f"shard/{i}"]), i


# -- the names gained for the reference's surface ---------------------------
def test_int_parameter(ref):
    from pint_tpu_torch.models.parameter import intParameter

    ip = intParameter("NHARM")
    ip.set_from_tokens(["30.0"])
    assert ip.value == int(ref["int/value"]) and isinstance(ip.value, int)
    assert ip.internal() == float(ref["int/internal"])
    assert ip.as_parfile_line() == str(ref["int/line"])


def test_s_to_bool(ref):
    from pint_tpu_torch.exceptions import PintTpuError
    from pint_tpu_torch.models.parameter import s_to_bool

    got = [s_to_bool(s) for s in ("y", "YES", "t", "True", "1", "n", "No",
                                  "F", "false", " 0 ")]
    assert got == list(ref["bool"])
    with pytest.raises(PintTpuError, match="cannot parse bool"):
        s_to_bool("maybe")


def test_prefix_parameter(ref):
    from pint_tpu_torch.models.parameter import (
        floatParameter,
        prefixParameter,
    )

    fam = prefixParameter(
        "DMX_", index_format="04d",
        template=lambda n: floatParameter(n, units="pc/cm^3"))
    got = [-1 if fam.match(n) is None else fam.match(n)
           for n in ("DMX_0017", "dmx_3", "DMX_", "DMXR1_0001", "F2")]
    assert got == list(ref["prefix/match"])
    inst = fam.instance(17)
    assert inst.name == str(ref["prefix/name"])
    assert inst.index == int(ref["prefix/index"])


def test_func_parameter_and_quantity(ref):
    from pint_tpu_torch.models.builder import get_model
    from pint_tpu_torch.models.parameter import funcParameter

    m = get_model(EPOCH_PAR)
    fp = funcParameter("DMSUM", func=lambda a, b: a + b,
                       params=("DMX_0001", "DMX_0002"))
    assert fp.evaluate(m) == float(ref["func/value"])
    assert (funcParameter("X", func=lambda a: a, params=("F1",))
            .evaluate(m) is None) == bool(ref["func/none"])
    assert fp.as_parfile_line() == str(ref["func/line"]) == ""
    for n in ("DMX_0002", "JUMP1"):
        assert m.params[n].quantity == float(ref[f"quantity/{n}"]), n
    assert [m.params[n].name_no_index for n in ("JUMP1", "JUMP2")] == list(
        ref["name_no_index"])


def test_parfile_dict_to_text(ref):
    from pint_tpu_torch.io.par import parfile_dict_to_text, parse_parfile

    text = parfile_dict_to_text(parse_parfile(EPOCH_PAR))
    assert text == str(ref["par_text"])
    assert parse_parfile(text) == parse_parfile(EPOCH_PAR)


def test_dmx_masks(ref):
    from pint_tpu_torch.models.builder import get_model
    from pint_tpu_torch.timebase.times import TimeArray
    from pint_tpu_torch.toas.ingest import ingest_barycentric
    from pint_tpu_torch.toas.toas import TOAs

    m = get_model(EPOCH_PAR)
    t = TimeArray.from_mjd_float(epoch_mjds(), scale="utc")
    toas = TOAs(t, np.full(t.mjd_int.shape, 1400.0),
                np.ones(t.mjd_int.shape), ["@"] * len(t.mjd_int))
    ingest_barycentric(toas)
    got = m.components["DispersionDMX"].dmx_masks(toas)
    want = {k[len("dmx_masks/"):]: v for k, v in ref.items()
            if k.startswith("dmx_masks/")}
    assert sorted(got) == sorted(want) == ["DMX_0001", "DMX_0002"]
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
    # the compiled range matrix is the same masks, column by column
    M = m.components["DispersionDMX"].extra_masks(toas.table())
    cols = list(M.values())[0]
    assert np.array_equal(cols, np.stack([want["DMX_0001"],
                                          want["DMX_0002"]], axis=1))


def test_has_tzr_anchor(ref):
    from pint_tpu_torch.models.builder import get_model

    got = [get_model(EPOCH_PAR).has_tzr_anchor(),
           get_model(TZR_PAR).has_tzr_anchor()]
    assert got == list(ref["tzr"]) == [False, True]


def _dd_pair(ref, key):
    return ref[f"dd/{key}/hi"], ref[f"dd/{key}/lo"]


def test_dd_abs_reshape_sum_from_string(ref):
    import torch

    from pint_tpu_torch.ops.dd import DD, dd_abs

    a, la, b, lb = dd_inputs()
    x = DD(torch.as_tensor(a * np.sign(b)), torch.as_tensor(la * np.sign(b)))
    for key, v in (("abs", dd_abs(x)), ("reshape", x.reshape(8, 8)),
                   ("sum_all", x.sum()), ("sum0", x.reshape(8, 8).sum(0)),
                   ("sum1", x.reshape(8, 8).sum(axis=1)),
                   ("string", DD.from_string(
                       "339.315687326475123456789012345"))):
        hi, lo = _dd_pair(ref, key)
        assert np.array_equal(v.hi.numpy(), hi), key
        assert np.array_equal(v.lo.numpy(), lo), key


def test_tdb_minus_tt_mjd(ref):
    from pint_tpu_torch.timebase.tdb import tdb_minus_tt_mjd

    got = tdb_minus_tt_mjd(np.array([51544, 55000, 58849]),
                           np.array([43200.0, 1234.5678, 86399.9]))
    assert np.array_equal(np.asarray(got), ref["tdb_mjd"])


def test_time_array_from_mjd_two_part(ref):
    from pint_tpu_torch.timebase.times import TimeArray

    ta = TimeArray.from_mjd_two_part(55000, 4321.125, scale="tt")
    assert np.array_equal([ta.mjd_int[0], ta.sec.hi[0], ta.sec.lo[0]],
                          ref["two_part"])
    assert ta.scale == str(ref["two_part/scale"])


def test_hostdd_to_device_and_split(ref):
    import torch

    from pint_tpu_torch.timebase.hostdd import HostDD

    h = HostDD(np.array([1.5, -2.25e8, 7.0]), np.array([1e-17, 3e-9, -2e-16]))
    d = h.to_device("cpu")
    assert d.hi.dtype == torch.float64 and d.hi.device.type == "cpu"
    assert np.array_equal(np.stack([d.hi.numpy(), d.lo.numpy()]),
                          ref["to_device"])
    a, la, _, _ = dd_inputs()
    ip, fr = HostDD(a, la).split_int_frac()
    assert np.array_equal(ip, ref["split/int"])
    assert np.array_equal(fr, ref["split/frac"])


# -- the public names of both packages --------------------------------------
def _reference_names() -> set:
    """Top-level public functions and classes of every module of the
    reference, and the public methods of each class, as ``Class.name``."""
    out = set()
    for f in (REPO / "pint_tpu").rglob("*.py"):
        for node in ast.parse(f.read_text()).body:
            if not isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                continue
            if node.name.startswith("_"):
                continue
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(
                    f"{node.name}.{sub.name}" for sub in node.body
                    if isinstance(sub, ast.FunctionDef)
                    and (not sub.name.startswith("_")
                         or sub.name == "__call__"))
    return out


def test_every_reference_public_name_has_a_counterpart():
    """The port defines (or inherits) every public name of the reference
    but the JAX-only ones, each of which still exists in the reference."""
    import pint_tpu_torch

    mods = [importlib.import_module(m.name) for m in pkgutil.walk_packages(
        pint_tpu_torch.__path__, "pint_tpu_torch.")]
    classes: dict = {}
    for mod in mods:
        for k, v in vars(mod).items():
            if isinstance(v, type):
                classes.setdefault(k, []).append(v)

    def present(name):
        if "." in name:
            cls, attr = name.split(".")
            return any(hasattr(c, attr) for c in classes.get(cls, ()))
        return any(hasattr(m, name) for m in mods)

    names = _reference_names()
    assert JAX_ONLY <= names
    missing = sorted(n for n in names - JAX_ONLY if not present(n))
    assert not missing, missing
