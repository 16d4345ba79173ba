"""The port's host IO layer: par and tim parsing, clock files, parameter
round trips, the native MJD parser, FITS orbit tables and satellite
observatories.

Port twins of ``tests/test_io.py``, ``tests/test_native.py``,
``tests/test_satellite.py`` and
``tests/test_pintk_globalclock.py::test_global_clock_update``: each test
runs on ``pint_tpu_torch`` with the reference test's inputs and
expectations.  The one change of form:
a mask parameter selects over a host TOA table (a dict of columns, what
``TOAs.table`` gives), where the reference's selects over a TOAs object.
Nothing of the JAX package is imported.
"""

import copy

import numpy as np
import pytest

from pint_tpu_torch import native
from pint_tpu_torch.exceptions import ClockCorrectionOutOfRange, PintTpuError
from pint_tpu_torch.io.clock import ClockFile
from pint_tpu_torch.io.fits import write_event_fits
from pint_tpu_torch.io.par import parse_parfile
from pint_tpu_torch.io.tim import get_TOAs_from_tim, write_tim_file
from pint_tpu_torch.models.parameter import (
    AngleParameter,
    MJDParameter,
    boolParameter,
    floatParameter,
    maskParameter,
    split_prefixed_name,
)
from pint_tpu_torch.observatory.satellite import (
    SatelliteObs,
    register_satellite,
)
from pint_tpu_torch.timebase.hostdd import HostDD
from pint_tpu_torch.timebase.times import TimeArray

PAR = """
PSR              J1744-1134
RAJ      17:44:29.403209  1  0.00000085
DECJ    -11:34:54.68067   1  0.00007
F0       245.4261196898081  1  5e-13
F1      -5.38156D-16      1  2e-21
PEPOCH   55000
DM       3.1380  1  0.0002
# a comment
C an old-style comment
JUMP -f L-wide 0.000052 1
JUMP mjd 55000 56000 0.0001
UNITS TDB
"""

TIM = """FORMAT 1
# comment
unk 1400.000000 55000.123456789012345 1.500 gbt -f L-wide -pn 0
unk 1440.000000 55100.223456789012345 2.000 gbt -f L-wide
TIME 0.5
unk 428.000000 55200.323456789012345 3.000 ao -f 430
SKIP
unk 999.0 55999.9 9.9 gbt
NOSKIP
unk 0.0 55300.423456789012345 1.000 @
END
ignored after end
"""


# -- tests/test_io.py ---------------------------------------------------------
def test_parse_parfile(tmp_path):
    d = parse_parfile(PAR)
    assert d["PSR"] == [["J1744-1134"]]
    assert d["F0"][0][0] == "245.4261196898081"
    assert len(d["JUMP"]) == 2
    assert "C" not in d and "#" not in d
    # file path input
    p = tmp_path / "test.par"
    p.write_text(PAR)
    d2 = parse_parfile(str(p))
    assert d2 == d


def test_float_parameter_dd_precision():
    p = floatParameter("F0", units="Hz", long_double=True)
    p.set_from_tokens(["245.4261196898081", "1", "5e-13"])
    assert not p.frozen
    assert p.uncertainty == 5e-13
    # value parsed exactly: re-format must round-trip all digits
    s = p._format_value()
    assert s.startswith("245.4261196898081")
    # Fortran exponent
    p2 = floatParameter("F1", units="Hz/s")
    p2.set_from_tokens(["-5.38156D-16"])
    assert p2.value == -5.38156e-16


def test_mjd_parameter():
    p = MJDParameter("PEPOCH")
    p.set_from_tokens(["55000.000000123456789"])
    day, sec = p.internal()
    assert day == 55000
    np.testing.assert_allclose(
        float(sec.to_float()), 0.000000123456789 * 86400, rtol=1e-12
    )


def test_angle_parameter_roundtrip():
    raj = AngleParameter("RAJ", units="H:M:S")
    raj.set_from_tokens(["17:44:29.403209", "1", "0.00000085"])
    # 17h44m29.4s in radians
    expect = (17 + 44 / 60 + 29.403209 / 3600) * np.pi / 12
    np.testing.assert_allclose(raj.value, expect, rtol=1e-15)
    assert raj._format_value().startswith("17:44:29.403209")
    decj = AngleParameter("DECJ", units="D:M:S")
    decj.set_from_tokens(["-11:34:54.68067"])
    assert decj.value < 0
    assert decj._format_value().startswith("-11:34:54.68067")
    # uncertainty conversion: H:M:S uncertainties are seconds of time
    np.testing.assert_allclose(
        raj.internal_uncertainty(), 0.00000085 * np.pi / (12 * 3600),
        rtol=1e-12
    )


def test_mask_parameter():
    j = maskParameter("JUMP1")
    j.set_from_tokens(["-f", "L-wide", "0.000052", "1"])
    assert j.key == "-f" and j.key_value == ["L-wide"]
    assert j.value == 0.000052 and not j.frozen
    j2 = maskParameter("JUMP2")
    j2.set_from_tokens(["mjd", "55000", "56000", "0.0001"])
    assert j2.key == "mjd"
    table = {
        "flags": [{"f": "L-wide"}, {"f": "430"}, {"f": "L-wide"}],
        "freq_mhz": np.array([1400.0, 428.0, 1440.0]),
        "mjd_float": np.array([54000.0, 55500.0, 57000.0]),
    }
    np.testing.assert_array_equal(j.select(table), [True, False, True])
    np.testing.assert_array_equal(j2.select(table), [False, True, False])


def test_split_prefixed_name():
    assert split_prefixed_name("DMX_0017") == ("DMX_", "0017", 17)
    assert split_prefixed_name("F12") == ("F", "12", 12)
    assert split_prefixed_name("GLF0_2") == ("GLF0_", "2", 2)
    with pytest.raises(Exception):
        split_prefixed_name("RAJ")


def test_bool_parameter():
    b = boolParameter("PLANET_SHAPIRO")
    for s, v in [("Y", True), ("N", False), ("1", True), ("0", False)]:
        b.set_from_tokens([s])
        assert b.value is v


def test_tim_parsing(tmp_path):
    p = tmp_path / "test.tim"
    p.write_text(TIM)
    toas = get_TOAs_from_tim(p)
    assert len(toas) == 4  # SKIP block and after-END excluded
    assert toas.obs == ["gbt", "gbt", "ao", "@"]
    np.testing.assert_allclose(toas.error_us, [1.5, 2.0, 3.0, 1.0])
    assert toas.flags[0]["f"] == "L-wide"
    assert toas.flags[0]["pn"] == "0"
    # TIME command applied to subsequent TOAs (baked into arrival time)
    sec2 = toas.t.sec.to_float()[2]
    np.testing.assert_allclose(
        sec2, 0.323456789012345 * 86400 + 0.5, rtol=1e-15
    )
    assert "to" not in toas.flags[2]
    # infinite frequency for 0.0
    assert np.isinf(toas.freq[3])
    # exact sub-ns MJD parse: .123456789012345 day
    sec = toas.t.sec.to_float()[0]
    np.testing.assert_allclose(sec, 0.123456789012345 * 86400, rtol=1e-15)


def test_tim_roundtrip(tmp_path):
    p = tmp_path / "a.tim"
    p.write_text(TIM)
    toas = get_TOAs_from_tim(p)
    out = tmp_path / "b.tim"
    write_tim_file(out, toas)
    toas2 = get_TOAs_from_tim(out)
    assert len(toas2) == len(toas)
    assert toas2.obs == toas.obs
    d = (toas2.t.sec - toas.t.sec).to_float()
    np.testing.assert_allclose(d, 0.0, atol=1e-9)  # 16-digit write
    np.testing.assert_array_equal(toas2.t.mjd_int, toas.t.mjd_int)
    assert toas2.flags[0]["f"] == "L-wide"


def test_clock_file(tmp_path):
    clk = tmp_path / "gbt.clk"
    clk.write_text(
        "# UTC(gbt) UTC\n50000.0 1.0e-6\n51000.0 3.0e-6\n52000.0 2.0e-6\n"
    )
    cf = ClockFile.from_tempo2(clk, name="gbt")
    np.testing.assert_allclose(cf.evaluate([50500.0]), 2.0e-6)
    np.testing.assert_allclose(cf.evaluate([51500.0]), 2.5e-6)
    with pytest.raises(ClockCorrectionOutOfRange):
        cf.evaluate([49000.0], limits="error")
    with pytest.warns(UserWarning):
        cf.evaluate([53000.0], limits="warn")
    # composition
    cf2 = ClockFile(np.array([50000.0, 52000.0]), np.array([1e-6, 1e-6]))
    tot = cf + cf2
    np.testing.assert_allclose(tot.evaluate([51000.0]), 4.0e-6)
    # tempo format (microseconds)
    tclk = tmp_path / "time_gbt.dat"
    tclk.write_text("  50000.0  1.5\n  51000.0  2.5\n")
    cft = ClockFile.from_tempo(tclk)
    np.testing.assert_allclose(cft.evaluate([50500.0]), 2.0e-6)


def test_merge_refuses_mixed_geometry_provenance():
    """A barycentric-ingested set (ephem=None, geometry populated) must
    not merge with an ephemeris-tagged set: their geometry columns come
    from different provenance."""
    from pint_tpu_torch.simulation import make_test_pulsar
    from pint_tpu_torch.toas.toas import merge_TOAs

    par = "PSR M\nF0 100.0\nPEPOCH 55000\n"
    _, t1 = make_test_pulsar(par, ntoa=8, seed=0, obs="@", device="cpu")
    _, t2 = make_test_pulsar(par, ntoa=8, start_mjd=56100.0,
                             end_mjd=56400.0, seed=1, obs="@",
                             device="cpu")
    assert t1.ssb_obs_pos is not None
    t2 = copy.deepcopy(t2)
    t2.ephem = "DE440"
    with pytest.raises(ValueError, match="different\\s+ephemerides"):
        merge_TOAs([t1, t2])
    # identical provenance still merges and keeps the (None) tag
    merged = merge_TOAs([t1, copy.deepcopy(t1)])
    assert merged.ephem is None and len(merged) == 16


# -- tests/test_native.py -----------------------------------------------------
needs_native = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)


@needs_native
def test_native_parse_matches_decimal_path():
    rng = np.random.default_rng(0)
    strings = ["51544", "55000.5", "55000.", "  58000.123  "]
    for _ in range(200):
        day = rng.integers(40000, 60000)
        ndig = rng.integers(1, 20)
        frac = "".join(rng.choice(list("0123456789"), ndig))
        strings.append(f"{day}.{frac}")
    day, hi, lo = native.parse_mjd_strings(strings)
    for i, s in enumerate(strings):
        s = s.strip()
        ip, _, fp = s.partition(".")
        assert day[i] == int(ip)
        ref = HostDD.from_string("0." + (fp or "0")) * 86400.0
        got = HostDD(hi[i], lo[i])
        # agreement far below the ns level (~1e-27 s)
        diff = abs(
            (float(got.hi) - float(ref.hi)) + (float(got.lo) - float(ref.lo))
        )
        assert diff < 1e-24, (s, diff)


@needs_native
def test_native_parse_bit_exact_hi():
    """The hi word must be the correctly-rounded double for every
    input (the lo word may differ by ~1e-32 relative)."""
    strings = [f"{55000 + i}.{'0123456789' * 1}" for i in range(50)]
    day, hi, lo = native.parse_mjd_strings(strings)
    for i, s in enumerate(strings):
        _, _, fp = s.partition(".")
        ref = HostDD.from_string("0." + fp) * 86400.0
        assert hi[i] == float(ref.hi), s


@needs_native
def test_native_parse_rejects_bad_strings():
    with pytest.raises(ValueError, match="index 1"):
        native.parse_mjd_strings(["55000.5", "-100.2"])
    with pytest.raises(ValueError):
        native.parse_mjd_strings(["55000.5x"])
    with pytest.raises(ValueError):
        native.parse_mjd_strings([""])
    with pytest.raises(ValueError):  # int64-overflow guard
        native.parse_mjd_strings(["9999999999999999999.5"])
    with pytest.raises(ValueError, match="ASCII"):
        native.parse_mjd_strings(["−55000.5"])


@needs_native
def test_from_mjd_strings_error_types_match_python():
    """Error surface must be environment-independent: PintTpuError for
    bad input and unknown formats, native lib or not."""
    with pytest.raises(PintTpuError):
        TimeArray.from_mjd_strings(["-100.2"])
    with pytest.raises(PintTpuError, match="format"):
        TimeArray.from_mjd_strings(["55000.5"], scale="tdb", format="mdj")


@needs_native
def test_from_mjd_strings_uses_native_and_matches(monkeypatch):
    strings = ["55000.0000116", "56123.999999999999"]
    t_native = TimeArray.from_mjd_strings(strings)
    monkeypatch.setenv("PINT_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    t_python = TimeArray.from_mjd_strings(strings)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    np.testing.assert_array_equal(t_native.mjd_int, t_python.mjd_int)
    np.testing.assert_allclose(
        t_native.sec.hi, t_python.sec.hi, rtol=0, atol=0
    )
    np.testing.assert_allclose(
        t_native.sec.lo, t_python.sec.lo, rtol=0, atol=1e-24
    )


def test_native_library_named_by_source_hash():
    """The parser is built from the checkout's source into the
    git-ignored ``_build/``, one library per hash of that source."""
    import hashlib

    path = native.library_path()
    assert path.parent.name == "_build"
    assert hashlib.sha256(
        native._SRC.read_bytes()).hexdigest()[:12] in path.name


# -- tests/test_satellite.py --------------------------------------------------
R_ORB = 6.8e6  # ~LEO radius, m
PERIOD_S = 5550.0


def _circular_orbit_met(met):
    w = 2 * np.pi / PERIOD_S
    return np.stack([
        R_ORB * np.cos(w * met), R_ORB * np.sin(w * met),
        np.zeros_like(met),
    ], axis=-1)


@pytest.fixture
def orbit_file(tmp_path):
    met = np.arange(0.0, 20000.0, 10.0)
    pos = _circular_orbit_met(met)
    path = str(tmp_path / "orbit.fits")
    write_event_fits(
        path,
        {"TIME": met, "X": pos[:, 0], "Y": pos[:, 1], "Z": pos[:, 2]},
        header_extra={"MJDREFI": 56000, "MJDREFF": 0.0,
                      "TIMEZERO": 0.0, "TIMESYS": "TT"},
        extname="ORBIT",
    )
    return path


def test_orbit_interpolation(orbit_file):
    sat = SatelliteObs.from_orbit_file("testsat", orbit_file)
    assert sat.is_satellite
    # interpolate at off-grid epochs: compare to the analytic orbit
    met = np.array([1234.5, 9876.25, 15000.125])
    mjd_tt = 56000.0 + met / 86400.0
    pos, vel = sat.posvel_gcrs(mjd_tt)
    np.testing.assert_allclose(
        pos, _circular_orbit_met(met), atol=5.0  # spline vs circle, m
    )
    # speed ~ w R
    speed = np.linalg.norm(vel, axis=-1)
    np.testing.assert_allclose(
        speed, 2 * np.pi / PERIOD_S * R_ORB, rtol=1e-4
    )
    with pytest.raises(PintTpuError, match="outside"):
        sat.posvel_gcrs([56001.0])


@pytest.mark.filterwarnings("ignore:no Earth-orientation table")
def test_satellite_ingest(orbit_file, tmp_path):
    import pint_tpu_torch.observatory as obsmod

    register_satellite("testsat", orbit_file)
    try:
        from pint_tpu_torch.ephemeris import get_ephemeris, mjd_tdb_to_et
        from pint_tpu_torch.toas.ingest import ingest
        from pint_tpu_torch.toas.toas import TOAs

        # TOAs in UTC whose TT lands inside the orbit span: TT-UTC ~ 67 s
        n = 20
        mjd = 56000.0 + (np.linspace(500, 15000, n) - 67.184) / 86400.0
        toas = TOAs(
            TimeArray.from_mjd_float(mjd, scale="utc"),
            np.full(n, np.inf), np.zeros(n), ["testsat"] * n,
            [dict() for _ in range(n)],
        )
        ingest(toas)
        # geometry: |ssb_obs - earth_ssb| = orbit radius
        eph = get_ephemeris("builtin")
        et = mjd_tdb_to_et(
            toas.t_tdb.mjd_int, toas.t_tdb.sec.to_float()
        )
        epos, _ = eph.ssb_posvel(399, et)
        r = np.linalg.norm(toas.ssb_obs_pos - epos * 1000.0, axis=-1)
        np.testing.assert_allclose(r, R_ORB, rtol=1e-4)
        # no troposphere geometry for spacecraft
        assert np.all(toas.obs_alt_m == 0.0)
    finally:
        obsmod.reset_registry()


# -- tests/test_pintk_globalclock.py ------------------------------------------
def test_global_clock_update(tmp_path):
    from pint_tpu_torch.observatory.global_clock import (
        Index,
        update_clock_files,
    )

    repo = tmp_path / "repo"
    (repo / "t2").mkdir(parents=True)
    (repo / "t2" / "gbt2gps.clk").write_text(
        "# UTC(gbt) UTC(gps)\n50000 1e-6\n60000 1e-6\n"
    )
    (repo / "index.txt").write_text(
        "# file update valid-end\nt2/gbt2gps.clk 60000.0 60200.0\n"
    )
    dest = tmp_path / "clk"
    installed = update_clock_files(repo, clock_dir=dest, now_mjd=60050.0)
    assert installed == ["gbt2gps.clk"]
    assert (dest / "gbt2gps.clk").exists()
    with pytest.warns(UserWarning, match="stale"):
        update_clock_files(repo, clock_dir=dest, now_mjd=60500.0)
    idx = Index.from_file(repo / "index.txt")
    assert idx.stale_files(60500.0) == ["t2/gbt2gps.clk"]
    assert idx.stale_files(60050.0) == []
