"""The port's topocentric ingest, its chunked thread pool and its ingest
cache.

Port twins of ``tests/test_ingest_topo.py``, ``tests/test_ingest_append.py``,
``tests/test_ingest_parallel.py`` and
``tests/test_matrix_minimize_sim.py::test_make_fake_toas_fromtim``: each
test runs on ``pint_tpu_torch`` with the reference test's inputs and
expectations.
Where a reference test reads the flight recorder's metrics counters
(``ingest.cache.*``, ``ingest.parallel.degrades``), which the port leaves
out (they belong to ``obs/``), its twin observes the same event
directly: a spy on the ingest call counts what was ingested, and the
degrade's warning is caught.  Simulations and fits run with
``device="cpu"``.  Nothing of the JAX package is imported.
"""

import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from torch_ingest_env import (  # noqa: E402
    DATADIR,
    INGEST_STEMS,
    port_ingest_env,
)

from pint_tpu_torch.constants import AU  # noqa: E402
from pint_tpu_torch.exceptions import (  # noqa: E402
    PintTpuError,
    UnknownObservatory,
)
from pint_tpu_torch.models.builder import get_model  # noqa: E402
from pint_tpu_torch.observatory import (  # noqa: E402
    get_observatory,
    list_observatories,
)
from pint_tpu_torch.simulation import (  # noqa: E402
    make_fake_toas_uniform,
    make_test_pulsar,
)
from pint_tpu_torch.timebase.times import TimeArray  # noqa: E402
from pint_tpu_torch.toas import cache as tcache  # noqa: E402
from pint_tpu_torch.toas import ingest as ingest_mod  # noqa: E402
from pint_tpu_torch.toas import ingest_topo  # noqa: E402
from pint_tpu_torch.toas.cache import append_ingested, get_TOAs  # noqa: E402
from pint_tpu_torch.toas.ingest import ingest, ingest_for_model  # noqa: E402
from pint_tpu_torch.toas.toas import TOAs  # noqa: E402

pytestmark = pytest.mark.filterwarnings(
    "ignore:no site clock file", "ignore:no Earth-orientation table"
)


# -- tests/test_ingest_topo.py ------------------------------------------------
PAR = """
PSR              J0613-0200
RAJ              06:13:43.97
DECJ             -02:00:47.2
F0               326.6005670874
F1               -1.023e-15
PEPOCH           55000
DM               38.78
"""


def _gbt_toas(n=40, start=55000.0, stop=55365.0):
    t = TimeArray.from_mjd_float(np.linspace(start, stop, n), scale="utc")
    return TOAs(
        t, np.full(n, 1400.0), np.ones(n), ["gbt"] * n,
        [dict() for _ in range(n)],
    )


def test_registry_lookup_and_aliases():
    gbt = get_observatory("gbt")
    assert get_observatory("GBT") is gbt
    assert get_observatory("1") is gbt
    assert get_observatory("gb") is gbt
    assert get_observatory("@").is_barycenter
    with pytest.raises(UnknownObservatory):
        get_observatory("atlantis")
    assert "meerkat" in list_observatories()


def test_ingest_time_chain_offsets():
    from pint_tpu_torch.timebase.leapseconds import tai_minus_utc

    toas = _gbt_toas()
    ingest(toas)
    # TDB - UTC ~ (TAI-UTC at epoch: 34 s in 2009) + 32.184 +- few ms
    dt = (
        (toas.t_tdb.mjd_int - toas.t.mjd_int) * 86400.0
        + (toas.t_tdb.sec - toas.t.sec).to_float()
    )
    expect = tai_minus_utc(toas.t.mjd_int) + 32.184
    assert np.all(np.abs(dt - expect) < 0.01)


def test_ingest_annual_tdb_term():
    toas = _gbt_toas(n=200, start=55000.0, stop=55365.0)
    ingest(toas)
    t_tt = toas.t.to_scale("tt")
    dt = (
        (toas.t_tdb.mjd_int - t_tt.mjd_int) * 86400.0
        + (toas.t_tdb.sec - t_tt.sec).to_float()
    )
    # annual sinusoid, ~1.66 ms amplitude
    assert 1.2e-3 < np.max(dt) < 1.8e-3
    assert -1.8e-3 < np.min(dt) < -1.2e-3


def test_ingest_geometry():
    toas = _gbt_toas(n=120)
    ingest(toas, planets=True)
    r = np.linalg.norm(toas.ssb_obs_pos, axis=-1)
    assert np.all((0.96 * AU < r) & (r < 1.04 * AU))
    v = np.linalg.norm(toas.ssb_obs_vel, axis=-1)
    assert np.all((28e3 < v) & (v < 31.5e3))
    rs = np.linalg.norm(toas.obs_sun_pos, axis=-1)
    assert np.all((0.96 * AU < rs) & (rs < 1.05 * AU))
    rj = np.linalg.norm(toas.obs_planet_pos["jupiter"], axis=-1)
    assert np.all((3.9 * AU < rj) & (rj < 6.5 * AU))
    # diurnal signature: topocentric radius modulates by Earth radius
    assert 1e6 < np.ptp(r) < AU * 0.05


def test_clock_chain_files(tmp_path, monkeypatch):
    import pint_tpu_torch.observatory as obsmod

    (tmp_path / "gbt2gps.clk").write_text(
        "# UTC(gbt) UTC(gps)\n50000.0 1.5e-6\n60000.0 1.5e-6\n"
    )
    (tmp_path / "gps2utc.clk").write_text(
        "# UTC(gps) UTC\n50000.0 2.5e-7\n60000.0 2.5e-7\n"
    )
    (tmp_path / "tai2tt_bipm2021.clk").write_text(
        "# TT(TAI) TT(BIPM2021)\n50000.0 27.7e-6\n60000.0 27.7e-6\n"
    )
    monkeypatch.setenv("PINT_TPU_CLOCK_DIR", str(tmp_path))
    obsmod.reset_registry()
    try:
        toas = _gbt_toas(n=5)
        ingest(toas)
        np.testing.assert_allclose(toas.clock_corr_s, 1.75e-6, rtol=1e-9)
        # BIPM correction shifts TDB by the same constant
        toas2 = _gbt_toas(n=5)
        ingest(toas2, include_bipm=False)
        dt = (toas.t_tdb.sec - toas2.t_tdb.sec).to_float() - (
            toas.clock_corr_s - toas2.clock_corr_s
        )
        np.testing.assert_allclose(dt, 27.7e-6, atol=2e-9)
    finally:
        obsmod.reset_registry()


def test_mixed_sites_raise():
    t = TimeArray.from_mjd_float([55000.0, 55001.0], scale="utc")
    toas = TOAs(t, [1400.0] * 2, [1.0] * 2, ["gbt", "@"], None)
    with pytest.raises(PintTpuError, match="mixed"):
        ingest(toas)


def test_elevation_with_model():
    m = get_model(PAR)
    toas = _gbt_toas(n=50, start=55000.0, stop=55002.0)
    ingest(toas, model=m)
    elev = toas.obs_elevation_rad
    assert elev.shape == (50,)
    assert np.all(np.abs(elev) <= np.pi / 2)
    # over 2 days the source rises and sets at a mid-latitude site
    assert np.max(elev) > 0.3
    assert np.min(elev) < 0.0


def test_end_to_end_topocentric_roundtrip():
    """Simulate at GBT through the full chain; residuals of the
    generating model must be sub-ns (internal consistency), and a
    perturbed model must fit back to truth."""
    from pint_tpu_torch.fitting import DownhillWLSFitter

    m = get_model(PAR)
    toas = make_fake_toas_uniform(
        55000, 55300, 120, m, error_us=1.0, obs="gbt",
        freq_mhz=np.where(np.arange(120) % 2, 1400.0, 800.0),
        device="cpu",
    )
    cm = m.compile(toas, device="cpu")
    r = cm.time_residuals(cm.x0()).numpy()
    assert np.max(np.abs(r)) < 1e-9

    rng = np.random.default_rng(8)
    toas.t = toas.t.add_seconds(rng.normal(0, 1e-6, len(toas)))
    ingest(toas, model=m)
    m2 = get_model(PAR)
    m2.params["F0"].frozen = False
    m2.params["F1"].frozen = False
    m2.params["DM"].frozen = False
    m2.params["F0"].set_from_tokens(["326.60056708745", "1"])
    f = DownhillWLSFitter(toas, m2, device="cpu")
    f.fit_toas()
    assert f.converged
    f0 = float(m2.params["F0"].value.to_float())
    assert f0 == pytest.approx(326.6005670874, abs=5e-11)
    assert f.resids.rms_weighted() < 2e-6


# -- tests/test_ingest_append.py ----------------------------------------------
PAR_APPEND = """
PSR              J1744-1134
F0               245.4261196898081   1
F1               -5.38156E-16        1
PEPOCH           55000
DM               3.1380              1
"""


@pytest.fixture(scope="module")
def pulsar():
    return make_test_pulsar(PAR_APPEND, ntoa=60, seed=7, iterations=1,
                            obs="@", device="cpu")


def _strip_ingest(toas):
    """A raw (pre-ingest) copy: same rows, no derived columns."""
    raw = TOAs(
        toas.t, np.array(toas.freq), np.array(toas.error_us),
        list(toas.obs), [dict(f) for f in toas.flags],
    )
    raw.ephem = toas.ephem
    return raw


@pytest.fixture
def ingest_spy(monkeypatch):
    """The sizes of the TOA sets ingest_for_model is called on."""
    sizes = []
    real = ingest_mod.ingest_for_model

    def spying(t, m, **kw):
        sizes.append(len(t))
        return real(t, m, **kw)

    monkeypatch.setattr(ingest_mod, "ingest_for_model", spying)
    return sizes


def test_append_ingested_matches_full_ingest(pulsar):
    m, t = pulsar
    base, tail = t[:45], _strip_ingest(t[45:])
    assert tail.t_tdb is None
    merged = append_ingested(base, tail, m)
    assert len(merged) == 60
    np.testing.assert_array_equal(merged.t_tdb.mjd_int, t.t_tdb.mjd_int)
    np.testing.assert_array_equal(merged.t_tdb.sec.hi, t.t_tdb.sec.hi)
    np.testing.assert_array_equal(merged.t_tdb.sec.lo, t.t_tdb.sec.lo)
    np.testing.assert_array_equal(merged.ssb_obs_pos, t.ssb_obs_pos)


def test_append_ingested_counts_reuse(pulsar, monkeypatch):
    """Only the tail is ingested: the base's 50 rows are reused."""
    m, t = pulsar
    sizes = []
    real = ingest_for_model

    def spying(tt, mm, **kw):
        sizes.append(len(tt))
        return real(tt, mm, **kw)

    import pint_tpu_torch.toas.ingest as ingest_module

    monkeypatch.setattr(ingest_module, "ingest_for_model", spying)
    merged = append_ingested(t[:50], _strip_ingest(t[50:]), m)
    assert len(merged) == 60
    assert sizes == [10]


def test_append_ingested_tail_below_chunk(pulsar, monkeypatch):
    """A 3-TOA tail under chunked parallel ingest must be bit-equal
    to the serial path (the chunking contract)."""
    m, t = pulsar
    tail = _strip_ingest(t[57:])
    monkeypatch.setenv("PINT_TPU_INGEST_WORKERS", "4")
    merged = append_ingested(t[:57], tail, m)
    np.testing.assert_array_equal(merged.t_tdb.sec.hi, t.t_tdb.sec.hi)
    np.testing.assert_array_equal(merged.t_tdb.sec.lo, t.t_tdb.sec.lo)


def test_append_ingested_successive(pulsar):
    m, t = pulsar
    cur = t[:40]
    for lo, hi in ((40, 47), (47, 53), (53, 60)):
        cur = append_ingested(cur, _strip_ingest(t[lo:hi]), m)
    assert len(cur) == 60
    np.testing.assert_array_equal(cur.t_tdb.sec.hi, t.t_tdb.sec.hi)


def test_append_ingested_pre_ingested_tail_skips_reingest(pulsar):
    m, t = pulsar
    tail = t[55:]
    assert tail.t_tdb is not None
    merged = append_ingested(t[:55], tail, m)
    assert len(merged) == 60


def test_append_ingested_refuses_raw_base(pulsar):
    m, t = pulsar
    with pytest.raises(ValueError, match="already-ingested"):
        append_ingested(_strip_ingest(t[:40]), t[40:], m)


def test_tim_growth_reingests_only_tail(pulsar, tmp_path, monkeypatch,
                                        ingest_spy):
    from pint_tpu_torch.io.tim import write_tim_file

    m, t = pulsar
    monkeypatch.setenv("PINT_TPU_CACHE_DIR", str(tmp_path))
    tim = tmp_path / "grow.tim"
    write_tim_file(str(tim), t[:40])
    t1 = get_TOAs(str(tim), model=m, usepickle=True)
    assert len(t1) == 40
    # grow the file: the old rows stay a byte-exact prefix
    write_tim_file(str(tim), t)
    t2 = get_TOAs(str(tim), model=m, usepickle=True)
    assert len(t2) == 60
    assert ingest_spy == [40, 20]  # the first read, then the tail only
    # stitched columns must be bitwise the from-scratch full ingest of the
    # SAME tim file (the written file rounds arrival times)
    ref = get_TOAs(str(tim), model=m, usepickle=False)
    np.testing.assert_array_equal(t2.t_tdb.sec.hi, ref.t_tdb.sec.hi)
    np.testing.assert_array_equal(t2.t_tdb.sec.lo, ref.t_tdb.sec.lo)
    np.testing.assert_array_equal(t2.ssb_obs_pos, ref.ssb_obs_pos)


def test_model_change_invalidates_stitched_prefix(
    pulsar, tmp_path, monkeypatch, ingest_spy
):
    """The options key bakes the model par text: a changed model must
    MISS (full re-ingest), never stitch against stale columns."""
    from pint_tpu_torch.io.tim import write_tim_file

    m, t = pulsar
    monkeypatch.setenv("PINT_TPU_CACHE_DIR", str(tmp_path))
    tim = tmp_path / "inval.tim"
    write_tim_file(str(tim), t[:40])
    get_TOAs(str(tim), model=m, usepickle=True)
    write_tim_file(str(tim), t)
    m2 = get_model(PAR_APPEND.replace("3.1380", "9.9990"))
    del ingest_spy[:]
    t2 = get_TOAs(str(tim), model=m2, usepickle=True)
    assert len(t2) == 60
    assert ingest_spy == [60]  # a miss: the full set, no stitched tail


# -- tests/test_ingest_parallel.py --------------------------------------------
PAR_TOPO = """
PSR J1744-1134
F0 245.4261196898081 1
F1 -5.38e-16 1
PEPOCH 55000
DM 3.1380 1
RAJ 17:44:29.403209 1
DECJ -11:34:54.68067 1
"""


def _ingest_columns(toas):
    """Every derived ingest column as plain arrays (for bitwise
    comparison)."""
    cols = {
        "tdb_day": toas.t_tdb.mjd_int,
        "tdb_hi": toas.t_tdb.sec.hi,
        "tdb_lo": toas.t_tdb.sec.lo,
    }
    for c in (
        "clock_corr_s", "ssb_obs_pos", "ssb_obs_vel", "obs_sun_pos",
        "obs_lat_rad", "obs_alt_m", "obs_elevation_rad",
    ):
        v = getattr(toas, c)
        if v is not None:
            cols[c] = v
    for body, v in toas.obs_planet_pos.items():
        cols[f"planet:{body}"] = v
    return cols


def _assert_bit_identical(a, b):
    ca, cb = _ingest_columns(a), _ingest_columns(b)
    assert set(ca) == set(cb)
    for k in ca:
        np.testing.assert_array_equal(ca[k], cb[k], err_msg=k)


def _force_parallel(monkeypatch, workers, min_toas=4):
    monkeypatch.setenv("PINT_TPU_INGEST_WORKERS", str(workers))
    monkeypatch.setattr(ingest_topo, "_MIN_PARALLEL_TOAS", min_toas)


@pytest.mark.parametrize("stem", INGEST_STEMS)
def test_parallel_bit_identical_on_golden_sets(stem, monkeypatch):
    """Chunked ingest through the REAL chain (clock files, EOP table,
    SPK kernel, satellite orbit) equals serial ingest bitwise."""
    from pint_tpu_torch.io.tim import get_TOAs_from_tim

    with port_ingest_env(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(str(DATADIR / f"{stem}.par"))

        monkeypatch.setenv("PINT_TPU_INGEST_WORKERS", "0")
        serial = ingest_for_model(
            get_TOAs_from_tim(str(DATADIR / f"{stem}.tim")), model
        )
        _force_parallel(monkeypatch, workers=4)
        parallel = ingest_for_model(
            get_TOAs_from_tim(str(DATADIR / f"{stem}.tim")), model
        )
    if serial.t_tdb is None:
        pytest.skip(f"{stem}: barycentric (no topocentric chain)")
    _assert_bit_identical(serial, parallel)


def _make_topo(ntoa=600, obs="geocenter"):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model, toas = make_test_pulsar(
            PAR_TOPO, ntoa=ntoa, start_mjd=55000.0, end_mjd=55600.0,
            obs=obs, iterations=1, device="cpu",
        )
    return model, toas


def test_parallel_bit_identical_multisite(monkeypatch):
    """Uneven chunks over a multi-site synthetic set (two ground
    stations cycling) equal the serial pass bitwise."""
    model, toas = _make_topo(ntoa=601, obs=["gbt", "parkes"])
    monkeypatch.setenv("PINT_TPU_INGEST_WORKERS", "0")
    serial = ingest_for_model(toas[:], model)
    _force_parallel(monkeypatch, workers=5)
    parallel = ingest_for_model(toas[:], model)
    _assert_bit_identical(serial, parallel)


def test_worker_crash_degrades_to_serial(monkeypatch):
    """A crashing chunk worker degrades to one clean serial pass whose
    answer equals plain serial ingest (and the degrade is warned)."""
    model, toas = _make_topo()
    monkeypatch.setenv("PINT_TPU_INGEST_WORKERS", "0")
    serial = ingest_for_model(toas[:], model)

    real = ingest_topo._compute_chunk
    chunks = []

    def crashing(plan, t, obs, lo, hi, chunk):
        chunks.append(chunk)
        if chunk > 0:
            raise RuntimeError("injected ingest worker crash")
        return real(plan, t, obs, lo, hi, chunk)

    _force_parallel(monkeypatch, workers=4)
    monkeypatch.setattr(ingest_topo, "_compute_chunk", crashing)
    with pytest.warns(UserWarning, match="recomputing serially"):
        degraded = ingest_for_model(toas[:], model)
    assert max(chunks) > 0 and chunks[-1] == 0  # pool, then one serial
    _assert_bit_identical(serial, degraded)


def test_workers_env_zero_is_serial(monkeypatch):
    """PINT_TPU_INGEST_WORKERS=0 runs the single-chunk path (no pool)
    — the escape hatch must not change results either."""
    model, toas = _make_topo(ntoa=200)

    def no_pool(*a, **k):  # the pool must not be entered at all
        raise AssertionError("thread pool used despite WORKERS=0")

    monkeypatch.setattr(ingest_topo, "_run_parallel", no_pool)
    monkeypatch.setattr(ingest_topo, "_MIN_PARALLEL_TOAS", 4)
    monkeypatch.setenv("PINT_TPU_INGEST_WORKERS", "0")
    out = ingest_for_model(toas[:], model)
    assert out.t_tdb is not None


def _write_tim(path, toas):
    from pint_tpu_torch.io.tim import write_tim_file

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        write_tim_file(str(path), toas)


def test_cache_invalidates_on_each_key_axis(tmp_path, monkeypatch):
    monkeypatch.setenv("PINT_TPU_CACHE_DIR", str(tmp_path))
    model, toas = _make_topo(ntoa=40)
    tim = tmp_path / "k.tim"
    _write_tim(tim, toas)

    t1 = tcache.get_TOAs(str(tim), model=model, usepickle=True)
    assert tcache.load_cache(
        str(tim), model_par=model.as_parfile()
    ) is not None

    # axis 1: tim content (a changed row is NOT a pure append)
    _write_tim(tim, toas[: len(toas) - 1])
    assert tcache.load_cache(
        str(tim), model_par=model.as_parfile()
    ) is None
    _write_tim(tim, toas)
    # axis 2: ingest options (here: the model par text)
    assert tcache.load_cache(str(tim), model_par="PSR FAKE\n") is None
    # axis 3: ingest-code version
    monkeypatch.setattr(
        ingest_topo, "INGEST_CODE_VERSION", "ingest-r999"
    )
    assert tcache.load_cache(
        str(tim), model_par=model.as_parfile()
    ) is None
    monkeypatch.undo()
    # ... and the unperturbed key still hits, bit-identically
    monkeypatch.setenv("PINT_TPU_CACHE_DIR", str(tmp_path))
    t2 = tcache.get_TOAs(str(tim), model=model, usepickle=True)
    _assert_bit_identical(t1, t2)


def test_append_incremental_reingests_only_tail(tmp_path, monkeypatch):
    """Appending TOAs to a cached tim re-ingests ONLY the tail, and
    the stitched table is bit-identical to a full fresh ingest."""
    monkeypatch.setenv("PINT_TPU_CACHE_DIR", str(tmp_path))
    model, toas = _make_topo(ntoa=60)
    tim = tmp_path / "a.tim"
    _write_tim(tim, toas[:45])
    tcache.get_TOAs(str(tim), model=model, usepickle=True)

    ingested_sizes = []
    real = ingest_mod.ingest_for_model

    def spying(t, m, **kw):
        ingested_sizes.append(len(t))
        return real(t, m, **kw)

    monkeypatch.setattr(ingest_mod, "ingest_for_model", spying)
    _write_tim(tim, toas)  # same 45 rows + 15 appended
    got = tcache.get_TOAs(str(tim), model=model, usepickle=True)
    assert ingested_sizes == [15]  # tail only, never the prefix

    monkeypatch.setattr(ingest_mod, "ingest_for_model", real)
    fresh = tcache.get_TOAs(str(tim), model=model, usepickle=False)
    _assert_bit_identical(got, fresh)
    # the refreshed cache now full-hits on the grown file
    monkeypatch.setattr(ingest_mod, "ingest_for_model", spying)
    del ingested_sizes[:]
    again = tcache.get_TOAs(str(tim), model=model, usepickle=True)
    assert ingested_sizes == []  # a hit: nothing ingested
    _assert_bit_identical(again, fresh)


def test_shrunk_or_edited_file_falls_back_to_full(tmp_path, monkeypatch):
    monkeypatch.setenv("PINT_TPU_CACHE_DIR", str(tmp_path))
    model, toas = _make_topo(ntoa=30)
    tim = tmp_path / "s.tim"
    _write_tim(tim, toas)
    tcache.get_TOAs(str(tim), model=model, usepickle=True)

    _write_tim(tim, toas[:20])  # shrunk: cached rows are NOT a prefix
    got = tcache.get_TOAs(str(tim), model=model, usepickle=True)
    assert len(got) == 20
    fresh = tcache.get_TOAs(str(tim), model=model, usepickle=False)
    _assert_bit_identical(got, fresh)


# -- tests/test_matrix_minimize_sim.py::test_make_fake_toas_fromtim -----------
def test_make_fake_toas_fromtim(tmp_path):
    from pint_tpu_torch.io.tim import write_tim_file
    from pint_tpu_torch.simulation import make_fake_toas_fromtim

    par = ("PSR J1744-1134\nF0 245.4261196898081 1\nF1 -5.38e-16 1\n"
           "PEPOCH 55000\nDM 3.1380 1\n")
    m, toas = make_test_pulsar(par, ntoa=30, jitter_us=50.0, obs="@",
                               device="cpu")
    tim = tmp_path / "in.tim"
    write_tim_file(str(tim), toas)
    m2 = get_model(par)
    fake = make_fake_toas_fromtim(str(tim), m2, device="cpu")
    assert len(fake) == 30
    np.testing.assert_array_equal(fake.freq, toas.freq)
    cm = m2.compile(fake, device="cpu", subtract_mean=False)
    r = cm.time_residuals(cm.x0(), subtract_mean=False).numpy()
    assert np.max(np.abs(r)) < 1e-9  # model-perfect at the tim epochs
    # a TOAs object is copied, never changed
    before = toas.t.sec.hi.copy()
    make_fake_toas_fromtim(toas, m2, device="cpu")
    np.testing.assert_array_equal(toas.t.sec.hi, before)
