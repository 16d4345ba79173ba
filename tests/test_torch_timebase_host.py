"""The port's host time and geometry substrate: TimeArray and leap
seconds, the TDB series, Earth rotation, and the ephemerides.

Port twins of ``tests/test_timebase.py``, ``tests/test_earth.py``,
``tests/test_ephemeris.py`` and ``tests/test_tdb_series.py``: each test
runs on ``pint_tpu_torch`` with the reference test's inputs and
expectations.  The host double-double is held against the port's torch
DD (the reference holds it against its JAX DD).  One twin reads
something of the JAX package: the committed mini SPK kernel is held
against the independent mpmath evaluation of its theory
(``tests/oracle/mp_pipeline.py``, which imports the JAX package's data
tables), evaluated in one reference subprocess
(``tests/torch_reference.py``).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis_compat import given, settings, st

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import run_reference  # noqa: E402

from pint_tpu_torch.earth.rotation import (  # noqa: E402
    _NUT_TERMS,
    era,
    fundamental_args,
    gcrs_posvel_from_itrf,
    gmst82,
    itrf_to_gcrs_matrix,
    itrf_to_geodetic,
    mean_obliquity,
    nutation_angles,
)
from pint_tpu_torch.ephemeris import get_ephemeris, mjd_tdb_to_et  # noqa: E402
from pint_tpu_torch.ephemeris.builtin import (  # noqa: E402
    AU_KM,
    BuiltinEphemeris,
    _ecl_to_eq,
    _kepler_xyz,
)
from pint_tpu_torch.ephemeris.spk import (  # noqa: E402
    SPK,
    chebyshev_fit_records,
    write_spk_type2,
)
from pint_tpu_torch.ephemeris.time_ephemeris import (  # noqa: E402
    TimeEphemeris,
    build_time_ephemeris_spk,
    install_time_ephemeris,
    integrate_tdb_minus_tt,
)
from pint_tpu_torch.exceptions import PintTpuError  # noqa: E402
from pint_tpu_torch.timebase.hostdd import HostDD  # noqa: E402
from pint_tpu_torch.timebase.leapseconds import (  # noqa: E402
    calendar_to_mjd,
    is_leap_second_day,
    leap_second_table,
    tai_minus_utc,
)
from pint_tpu_torch.timebase.tdb import tdb_minus_tt  # noqa: E402
from pint_tpu_torch.timebase.times import TimeArray  # noqa: E402

DATADIR = Path(__file__).parent / "datafile"
YEAR_S = 365.25 * 86400.0
S_PER_DAY = 86400.0
GBT = np.array([882589.65, -4924872.32, 3943729.348])
#: the epochs of the mini-kernel check (tests/test_ephemeris.py's draw)
MINI_ET = ((54500.0 - 51544.5)
           + np.random.default_rng(7).uniform(0, 1400, 25)) * 86400.0

REF_SCRIPT = r"""
from oracle.mp_pipeline import earth_ssb_eq_km, sun_ssb_eq_km
et = np.asarray(json.loads(os.environ["MINI_ET"]))
e, s = [], []
for t in et:
    T = t / (36525.0 * 86400.0)
    e.append([float(v) for v in earth_ssb_eq_km(T)])
    s.append([float(v) for v in sun_ssb_eq_km(T)])
OUT["earth"] = np.array(e)
OUT["sun"] = np.array(s)
"""


@pytest.fixture(scope="module")
def mp_theory(tmp_path_factory):
    """The independent mpmath theory at MINI_ET (reference subprocess)."""
    import json

    out = tmp_path_factory.mktemp("ref") / "mp.npz"
    return run_reference(REF_SCRIPT, out,
                         env={"MINI_ET": json.dumps(MINI_ET.tolist())})


# -- tests/test_timebase.py ---------------------------------------------------
def test_calendar_to_mjd_anchors():
    # independent public anchors
    assert calendar_to_mjd(1858, 11, 17) == 0
    assert calendar_to_mjd(1970, 1, 1) == 40587
    assert calendar_to_mjd(2000, 1, 1) == 51544
    assert calendar_to_mjd(1972, 1, 1) == 41317
    assert calendar_to_mjd(2017, 1, 1) == 57754


def test_leap_second_table():
    mjds, offs = leap_second_table()
    assert len(mjds) == 28
    assert offs[0] == 10 and offs[-1] == 37
    assert np.all(np.diff(offs) == 1)
    assert tai_minus_utc(41317) == 10
    assert tai_minus_utc(57754) == 37
    assert tai_minus_utc(60000) == 37
    # day before 2017-01-01 step had 86401 s
    assert is_leap_second_day(57753)
    assert not is_leap_second_day(57752)
    with pytest.raises(PintTpuError):
        tai_minus_utc(41000)


def test_hostdd_matches_device_dd():
    """Host numpy DD and the port's torch DD agree bit for bit on the
    CPU."""
    import torch

    from pint_tpu_torch.ops.dd import DD

    rng = np.random.default_rng(0)
    a = rng.uniform(-1e9, 1e9, 50)
    b = rng.uniform(-1e3, 1e3, 50)
    h = (HostDD(a) / HostDD(b) + HostDD(b) * 3.7) - 1.25
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    d = (DD.from_float(ta) / DD.from_float(tb)
         + DD.from_float(tb) * 3.7) - 1.25
    np.testing.assert_array_equal(h.hi, d.hi.numpy())
    np.testing.assert_array_equal(h.lo, d.lo.numpy())


mjd_int_st = st.integers(min_value=41317, max_value=69000)
frac_digits_st = st.text(alphabet="0123456789", min_size=1, max_size=18)


@given(mjd_int_st, frac_digits_st)
@settings(max_examples=100, deadline=None)
def test_mjd_string_roundtrip(day, frac):
    s = f"{day}.{frac}"
    t = TimeArray.from_mjd_strings([s], scale="utc")
    back = t.to_mjd_strings(ndigits=19)[0]
    # compare as decimals (trailing zeros allowed)
    from decimal import Decimal

    assert abs(Decimal(back) - Decimal(s)) < Decimal("1e-19") * 86400


@given(mjd_int_st, st.floats(min_value=0.0, max_value=86399.999))
@settings(max_examples=80, deadline=None)
def test_scale_chain_roundtrip(day, sec):
    t = TimeArray(np.array([day]), HostDD(np.array([sec])), "utc")
    for target in ["tai", "tt", "tdb", "tcb", "tcg"]:
        back = t.to_scale(target).to_scale("utc")
        assert back.scale == "utc"
        d_day = back.mjd_int - t.mjd_int
        d_sec = (back.sec - t.sec).to_float() + d_day * 86400.0
        assert abs(float(d_sec[0])) < 1e-13, (target, float(d_sec[0]))


def test_known_offsets_2020():
    """TT-UTC = 69.184 s after 2017; TDB within 2 ms of TT."""
    t = TimeArray.from_mjd_strings(["59000.0"], scale="utc")
    tt = t.to_scale("tt")
    dt = tt.seconds_since(59000) - t.seconds_since(59000)
    np.testing.assert_allclose(dt.to_float(), 69.184, atol=1e-12)
    tdb = t.to_scale("tdb")
    d_tdb = (tdb.seconds_since(59000) - tt.seconds_since(59000)).to_float()
    assert abs(float(d_tdb[0])) < 2e-3


def test_utc_day_crossing():
    """Conversions that push sec past midnight must carry the day."""
    t = TimeArray(np.array([57754]), HostDD(np.array([86399.0])), "utc")
    tai = t.to_scale("tai")
    assert tai.mjd_int[0] == 57755
    np.testing.assert_allclose(tai.sec.to_float()[0], 36.0, atol=1e-12)


def test_leap_day_formats_differ():
    # 57753.999999 in "mjd" format scales by 86401; pulsar_mjd by 86400
    s = "57753.99999"
    a = TimeArray.from_mjd_strings([s], scale="utc", format="pulsar_mjd")
    b = TimeArray.from_mjd_strings([s], scale="utc", format="mjd")
    diff = (b.sec - a.sec).to_float()[0]
    np.testing.assert_allclose(diff, 0.99999, atol=1e-9)
    # on a normal day they agree
    s = "57000.25"
    a = TimeArray.from_mjd_strings([s], format="pulsar_mjd")
    b = TimeArray.from_mjd_strings([s], format="mjd")
    assert float((b.sec - a.sec).to_float()[0]) == 0.0


def test_seconds_since_precision():
    """dt over 20 years carries ns structure exactly."""
    t = TimeArray.from_mjd_strings(
        ["51544.000000000000000001", "58849.000000000000000002"], scale="tdb"
    )
    dt = t.seconds_since(51544)
    span_days = 58849 - 51544
    expect = span_days * 86400.0
    got = dt[1] - HostDD(expect)
    # TOA[1]'s 2e-18-day fractional offset survives: 2e-18 MJD ~ 1.7e-13 s
    np.testing.assert_allclose(got.to_float(), 2e-18 * 86400, rtol=1e-6)
    np.testing.assert_allclose(dt.to_float()[0], 1e-18 * 86400, rtol=1e-6)


def test_leap_second_instant_roundtrip():
    """An instant *inside* a leap second (UTC sec 86400.5 of the leap
    day) must survive UTC->TAI->UTC exactly."""
    t = TimeArray(np.array([57753]), HostDD(np.array([86400.5])), "utc")
    tai = t.to_scale("tai")
    assert tai.mjd_int[0] == 57754
    np.testing.assert_allclose(tai.sec.to_float()[0], 36.5, atol=1e-12)
    back = tai.to_scale("utc")
    assert back.mjd_int[0] == 57753
    np.testing.assert_allclose(back.sec.to_float()[0], 86400.5, atol=1e-12)
    # and a plain second-of-day right after the leap second
    t2 = TimeArray(np.array([57754]), HostDD(np.array([0.25])), "utc")
    b2 = t2.to_scale("tai").to_scale("utc")
    assert b2.mjd_int[0] == 57754
    np.testing.assert_allclose(b2.sec.to_float()[0], 0.25, atol=1e-12)


def test_tdb_tcb_rates():
    """TCB drifts vs TDB at L_B ~ 1.55e-8 s/s."""
    t0 = TimeArray(np.array([43144]), HostDD(np.array([32.184])), "tdb")
    t1 = TimeArray(np.array([43144 + 36525]), HostDD(np.array([32.184])),
                   "tdb")
    d0 = (t0.to_scale("tcb").seconds_since(43144)
          - t0.seconds_since(43144)).to_float()
    d1 = (t1.to_scale("tcb").seconds_since(43144)
          - t1.seconds_since(43144)).to_float()
    # at T77 the offset is -TDB0 ~ +6.55e-5 s
    np.testing.assert_allclose(d0, 6.55e-5, rtol=1e-6)
    rate = (d1 - d0) / (36525 * 86400.0)
    np.testing.assert_allclose(rate, 1.550519768e-8, rtol=1e-6)


# -- tests/test_earth.py ------------------------------------------------------
def test_obliquity_j2000():
    assert mean_obliquity(0.0) == pytest.approx(
        np.deg2rad(84381.448 / 3600.0), rel=1e-12
    )


def test_gmst_and_era_at_j2000():
    # GMST at 2000-01-01 12:00 UT1 = 18h 41m 50.548s = 280.4606 deg
    g = gmst82(51544.5)
    assert np.rad2deg(g) == pytest.approx(280.4606, abs=2e-3)
    # ERA/2pi at J2000 = 0.7790572732640
    assert era(51544.5) == pytest.approx(
        2 * np.pi * 0.7790572732640, abs=1e-9
    )
    # both advance ~360.9856 deg/day
    assert np.rad2deg(
        np.mod(gmst82(51545.5) - g, 2 * np.pi)
    ) == pytest.approx(0.9856, abs=1e-3)


def test_nutation_principal_term():
    # near a node epoch the series is dominated by the 17.2" Om term;
    # check amplitude bound and that values move with time
    T = np.linspace(-0.5, 0.5, 200)  # 1900-2100
    dpsi, deps = nutation_angles(T)
    arcsec = np.rad2deg(dpsi) * 3600
    assert np.max(np.abs(arcsec)) < 19.0
    assert np.max(np.abs(arcsec)) > 15.0  # the Om term must appear
    deps_as = np.rad2deg(deps) * 3600
    assert 8.0 < np.max(np.abs(deps_as)) < 10.5


def test_rotation_matrix_orthonormal():
    M = itrf_to_gcrs_matrix(
        np.array([50000.0, 55000.0, 60000.0]),
        np.array([-0.1, 0.1, 0.2]),
    )
    eye = M @ np.swapaxes(M, -1, -2)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape),
                               atol=1e-13)
    np.testing.assert_allclose(np.linalg.det(M), 1.0, atol=1e-13)


def test_site_posvel_physics():
    mjd = np.linspace(55000.0, 55001.0, 97)  # one day, 15-min steps
    tt_cent = (mjd - 51544.5) / 36525.0
    pos, vel = gcrs_posvel_from_itrf(GBT, mjd, tt_cent)
    r = np.linalg.norm(pos, axis=-1)
    # radius preserved by rotation
    np.testing.assert_allclose(r, np.linalg.norm(GBT), rtol=1e-12)
    # speed = omega * r_perp; GBT latitude ~38.4 deg
    speed = np.linalg.norm(vel, axis=-1)
    expected = 7.2921e-5 * np.hypot(GBT[0], GBT[1])
    np.testing.assert_allclose(speed, expected, rtol=1e-3)
    # velocity perpendicular to position (pure rotation)
    dots = np.abs(np.sum(pos * vel, axis=-1) / (r * speed))
    assert np.max(dots) < 1e-5
    # sidereal periodicity: after 23h56m04.09s the position nearly repeats
    sidereal_day = 86164.0905 / 86400.0
    p2, _ = gcrs_posvel_from_itrf(
        GBT, 55000.0 + sidereal_day,
        (55000.0 + sidereal_day - 51544.5) / 36525.0
    )
    assert np.linalg.norm(p2 - pos[0]) < 50.0  # meters


def test_itrf_to_geodetic_gbt():
    lat, lon, h = itrf_to_geodetic(GBT[None, :])
    assert np.rad2deg(lat[0]) == pytest.approx(38.433, abs=0.01)
    assert np.rad2deg(lon[0]) == pytest.approx(-79.84, abs=0.01)
    assert h[0] == pytest.approx(820.0, abs=40.0)


# -- tests/test_ephemeris.py --------------------------------------------------
def test_builtin_earth_orbit_physics():
    eph = BuiltinEphemeris()
    et = np.linspace(0, YEAR_S, 365)
    epos, evel = eph.ssb_posvel(399, et)
    spos, _ = eph.ssb_posvel(10, et)
    r = np.linalg.norm(epos - spos, axis=-1) / AU_KM
    # heliocentric distance 0.983 - 1.017 AU
    assert 0.975 < r.min() < 0.99
    assert 1.01 < r.max() < 1.025
    # orbital speed ~29.8 km/s
    v = np.linalg.norm(evel, axis=-1)
    assert 28.5 < v.min() and v.max() < 31.0
    # period: after one anomalistic year the heliocentric position repeats
    p0, _ = eph.ssb_posvel(399, 0.0)
    p1, _ = eph.ssb_posvel(399, YEAR_S)
    s0, _ = eph.ssb_posvel(10, 0.0)
    s1, _ = eph.ssb_posvel(10, YEAR_S)
    ang = np.arccos(
        np.dot(p1 - s1, p0 - s0)
        / np.linalg.norm(p1 - s1) / np.linalg.norm(p0 - s0)
    )
    assert np.rad2deg(ang) < 1.5


def test_builtin_sun_ssb_offset():
    eph = BuiltinEphemeris()
    et = np.linspace(0, 30 * YEAR_S, 100)
    spos, _ = eph.ssb_posvel(10, et)
    r = np.linalg.norm(spos, axis=-1) / AU_KM
    # Sun wanders within ~2 solar radii (0.01 AU) of the SSB
    assert r.max() < 0.012
    assert r.max() > 0.002


def test_builtin_moon_earth_offset():
    eph = BuiltinEphemeris()
    epos, _ = eph.ssb_posvel(399, 0.0)
    mpos, _ = eph.ssb_posvel(301, 0.0)
    d = np.linalg.norm(mpos - epos)
    assert 356000.0 < d < 407000.0  # km, perigee..apogee


def test_mjd_tdb_to_et():
    assert mjd_tdb_to_et(51544, 43200.0) == 0.0
    assert mjd_tdb_to_et(51545, 43200.0) == 86400.0


def test_spk_write_read_roundtrip(tmp_path):
    """Write a 2-segment kernel (EMB<-SSB, Earth<-EMB) fit from the
    builtin ephemeris; read it back; evaluation must match the builtin
    to Chebyshev-fit precision, including the chained SSB composition."""
    eph = BuiltinEphemeris()
    t0, t1 = -YEAR_S, YEAR_S
    n_rec, deg = 64, 12

    def emb_km(et):
        return eph.ssb_posvel(3, et)[0]

    def earth_minus_emb(et):
        return eph.ssb_posvel(399, et)[0] - eph.ssb_posvel(3, et)[0]

    segs = [
        dict(target=3, center=0, init=t0, intlen=(t1 - t0) / n_rec,
             coeffs=chebyshev_fit_records(emb_km, t0, t1, n_rec, deg)),
        dict(target=399, center=3, init=t0, intlen=(t1 - t0) / n_rec,
             coeffs=chebyshev_fit_records(
                 earth_minus_emb, t0, t1, n_rec, deg)),
    ]
    path = tmp_path / "test.bsp"
    write_spk_type2(str(path), segs)

    spk = SPK.open(str(path))
    assert spk.bodies == [3, 399]
    et = np.linspace(t0 + 1e5, t1 - 1e5, 500)
    pos_spk, vel_spk = spk.ssb_posvel(399, et)
    pos_ref, vel_ref = eph.ssb_posvel(399, et)
    # positions to cm over the fit span; velocity to fit precision
    assert np.max(np.abs(pos_spk - pos_ref)) < 1e-4  # km = 10 cm
    assert np.max(np.abs(vel_spk - vel_ref)) < 1e-6  # km/s
    # pair evaluation too
    p3, _ = spk.pair_posvel(3, 0, 0.0)
    np.testing.assert_allclose(p3, eph.ssb_posvel(3, 0.0)[0], atol=1e-4)


def test_get_ephemeris_fallback_and_path(tmp_path):
    eph = get_ephemeris("builtin")
    assert isinstance(eph, BuiltinEphemeris)
    with pytest.warns(UserWarning, match="not found"):
        from pint_tpu_torch import ephemeris as ephmod

        ephmod._cache.pop("de999", None)
        eph2 = get_ephemeris("de999")
    assert isinstance(eph2, BuiltinEphemeris)


def test_mini_spk_vs_independent_theory(mp_theory):
    """The committed mini kernel (tests/datafile/mini_vsop87.bsp) read
    back through the port's SPK reader and batched Chebyshev evaluator
    matches an independent mpmath evaluation of the same theory to
    < 100 m."""
    spk = SPK.open(DATADIR / "mini_vsop87.bsp")
    pos_e, _ = spk.ssb_posvel(399, MINI_ET)
    pos_s, _ = spk.ssb_posvel(10, MINI_ET)
    for i, t in enumerate(MINI_ET):
        assert np.linalg.norm(pos_e[i] - mp_theory["earth"][i]) < 0.1, (
            f"earth @ {t}")
        assert np.linalg.norm(pos_s[i] - mp_theory["sun"][i]) < 0.1, (
            f"sun @ {t}")


def test_mini_spk_velocity_consistency():
    """Chebyshev-differentiated velocities from the committed kernel
    agree with the theory's central-difference velocities to mm/s."""
    spk = SPK.open(DATADIR / "mini_vsop87.bsp")
    eph = BuiltinEphemeris()
    et = np.linspace((54600.0 - 51544.5) * 86400.0,
                     (55800.0 - 51544.5) * 86400.0, 17)
    _, vel = spk.ssb_posvel(399, et)
    _, vel_ref = eph.ssb_posvel("earth", et)
    assert np.max(np.abs(vel - vel_ref)) < 1e-5  # km/s


def test_builtin_geocenter_accuracy_class():
    """Pin the builtin geocenter's accuracy class: the VSOP87 geocenter
    and the Kepler EMB path agree to the Kepler elements' documented
    ~10-20 arcsec (~2e4 km)."""
    eph = BuiltinEphemeris()
    et = np.linspace(0.0, 3.15e8, 50)  # 2000-2010
    t_cent = et / (36525.0 * 86400.0)
    earth = eph.ssb_pos("earth", et)
    emb_kepler = (
        _ecl_to_eq(eph._sun_ssb_au(t_cent) + _kepler_xyz("emb", t_cent))
        * AU_KM
    )
    sep = np.linalg.norm(earth - emb_kepler, axis=-1)
    # Earth vs EMB true offset is < 4700 km; the rest is Kepler error
    assert np.max(sep) < 4.0e4
    assert np.median(sep) > 1.0e2  # the two paths ARE distinct


# -- tests/test_tdb_series.py -------------------------------------------------
def _detrended_diff(et, a, b):
    """a - b with LSQ offset+slope removed (the integral's offset and
    mean rate are calibration, not signal)."""
    d = a - b
    t = (et - et.mean()) / (et[-1] - et[0])
    A = np.stack([np.ones_like(t), t], axis=-1)
    coef, *_ = np.linalg.lstsq(A, d, rcond=None)
    return d - A @ coef


def test_series_annual_amplitude():
    """The dominant annual term: 1.657 ms amplitude."""
    T = np.linspace(-0.1, 0.2, 20000)  # 1990-2020
    d = tdb_minus_tt(T)
    amp = (d.max() - d.min()) / 2.0
    assert 1.60e-3 < amp < 1.72e-3


def test_series_vs_defining_integral():
    """Two independent implementations agree to ~0.1 us RMS over
    2004-2020."""
    eph = BuiltinEphemeris()
    et0 = (53000.0 - 51544.5) * S_PER_DAY
    et1 = (58900.0 - 51544.5) * S_PER_DAY
    et, d_int = integrate_tdb_minus_tt(eph, et0, et1, step_s=43200.0)
    d_series = tdb_minus_tt(et / (36525.0 * S_PER_DAY))
    resid = _detrended_diff(et, d_series, d_int)
    rms = np.sqrt(np.mean(resid**2))
    assert rms < 150e-9, f"series vs integral RMS {rms*1e9:.0f} ns"
    assert np.max(np.abs(resid)) < 400e-9


def test_time_ephemeris_spk_roundtrip(tmp_path):
    """Chebyshev-compressed SPK product reproduces the integral to
    < 2 ns and installs as the global TT<->TDB provider."""
    eph = BuiltinEphemeris()
    path = tmp_path / "tdbtt.bsp"
    build_time_ephemeris_spk(path, eph, 55000.0, 55800.0)
    te = TimeEphemeris.open(path)

    et0 = (55050.0 - 51544.5) * S_PER_DAY
    et1 = (55750.0 - 51544.5) * S_PER_DAY
    et, d_int = integrate_tdb_minus_tt(
        eph, et0 - 30 * S_PER_DAY, et1 + 30 * S_PER_DAY, step_s=21600.0
    )
    sel = (et >= et0) & (et <= et1)
    d_spk = te.tdb_minus_tt(et[sel])
    resid = _detrended_diff(et[sel], d_spk, d_int[sel])
    assert np.max(np.abs(resid)) < 2e-9

    # install: host tdb_minus_tt now routes through the kernel
    try:
        install_time_ephemeris(te)
        T = et[sel][:5] / (36525.0 * S_PER_DAY)
        np.testing.assert_allclose(
            tdb_minus_tt(T), te.tdb_minus_tt(et[sel][:5]), rtol=0,
            atol=1e-12,
        )
    finally:
        install_time_ephemeris(None)
    # and back to the series after uninstall
    T_in = (55400.0 - 51544.5) / 36525.0
    assert abs(
        tdb_minus_tt(np.array([T_in]))[0]
        - te.tdb_minus_tt(T_in * 36525.0 * S_PER_DAY)
    ) > 0  # smoke: series path live again


def test_nutation_term_count_and_magnitude():
    """Extended IAU1980 table: 54 terms, principal term -17.1996" in
    longitude; total |dpsi| stays under 20"."""
    assert _NUT_TERMS.shape[0] >= 54
    T = np.linspace(-0.3, 0.3, 4000)
    dpsi, deps = nutation_angles(T)
    arcsec = np.pi / 180.0 / 3600.0
    assert np.max(np.abs(dpsi)) < 20 * arcsec
    assert np.max(np.abs(deps)) < 11 * arcsec
    # 18.6-yr principal term dominates: correlate dpsi with sin(Om)
    Om = fundamental_args(T)[4]
    c = np.corrcoef(dpsi, np.sin(Om))[0, 1]
    assert c < -0.95  # amplitude is negative


def test_tdb_integral_over_spk_ephemeris():
    """tdb_rate/integrate accept an SPK-backed ephemeris (NAIF-id
    bodies; planets absent from a partial kernel fall back to the
    builtin theory)."""
    spk = SPK.open(DATADIR / "mini_vsop87.bsp")
    et0 = (54600.0 - 51544.5) * S_PER_DAY
    et1 = (55300.0 - 51544.5) * S_PER_DAY
    et, d_spk = integrate_tdb_minus_tt(spk, et0, et1, step_s=86400.0)
    _, d_builtin = integrate_tdb_minus_tt(
        BuiltinEphemeris(), et0, et1, step_s=86400.0
    )
    # same theory underneath (the kernel was fit to it): tight match
    resid = _detrended_diff(et, d_spk, d_builtin)
    assert np.max(np.abs(resid)) < 5e-9
