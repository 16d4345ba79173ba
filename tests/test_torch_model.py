"""Parity of the PyTorch port's timing model with the JAX package.

The reference runs once per module in a subprocess (tests/torch_reference.py)
on bench.py's pulsar at 512 TOAs and on golden13 (ingested through the
committed clock/EOP/ephemeris data); its state is carried across with
``pint_tpu_torch.convert.state_from_numpy`` so both packages compute on
byte-identical inputs.  Tolerances are stated per test.
"""

import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import (  # noqa: E402
    BENCH_PAR,
    bench_build_script,
    golden13_script,
    load_state,
    run_reference,
)

from pint_tpu_torch.convert import state_from_numpy  # noqa: E402
from pint_tpu_torch.models.builder import get_model  # noqa: E402
from pint_tpu_torch.models.noise import host_fourier_basis  # noqa: E402
from pint_tpu_torch.models.timing_model import (  # noqa: E402
    reference_values,
)
from pint_tpu_torch.simulation import make_test_pulsar  # noqa: E402
from pint_tpu_torch.timebase.hostdd import HostDD  # noqa: E402

DATADIR = Path(__file__).parent / "datafile"
STATES = ["bench", "golden13"]

_SCRIPT = textwrap.dedent("""
from pint_tpu.models.builder import get_model
from pint_tpu.models.timing_model import reference_values
from pint_tpu.timebase.hostdd import HostDD
from torch_reference import BENCH_PAR

ref = reference_values(get_model(BENCH_PAR))
for n, v in ref.items():
    if isinstance(v, HostDD):
        OUT[f"parref/{n}"] = np.array([v.hi, v.lo], float)
    elif isinstance(v, tuple):
        OUT[f"parref/{n}"] = np.array([v[0], v[1].hi, v[1].lo], float)
    elif not isinstance(v, (bool, str)):
        OUT[f"parref/{n}"] = np.array([v], float)
OUT["sim/day"] = np.asarray(toas.t_tdb.mjd_int)
OUT["sim/hi"] = np.asarray(toas.t_tdb.sec.hi)
OUT["sim/lo"] = np.asarray(toas.t_tdb.sec.lo)
for name, c in (("bench", cm), ("golden13", g_cm)):
    x0 = c.x0()
    OUT[f"res/{name}/resid"] = np.asarray(c.time_residuals(x0))
    OUT[f"res/{name}/resid_nomean"] = np.asarray(
        c.time_residuals(x0, subtract_mean=False))
    OUT[f"res/{name}/design"] = np.asarray(c.design_matrix(x0))
    OUT[f"res/{name}/sigma"] = np.asarray(c.scaled_sigma(x0))
    T, phi = c.noise_basis_or_empty(x0)
    OUT[f"res/{name}/T"] = np.asarray(T)
    OUT[f"res/{name}/phi"] = np.asarray(phi)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    script = bench_build_script(512) + golden13_script() + _SCRIPT
    return run_reference(script, tmp_path_factory.mktemp("ref") / "model.npz")


def _compiled(ref, name):
    model, bundle, _ = state_from_numpy(load_state(ref, name), device="cpu")
    return model.compile(bundle)


def test_get_model_reference_values_exact(ref):
    """bench.py's par parsed by the port gives the reference's internal
    values bit for bit: floats, double-double hi and lo, epochs."""
    got = reference_values(get_model(BENCH_PAR))
    want = {k.split("/", 1)[1]: v for k, v in ref.items()
            if k.startswith("parref/")}
    numeric = {k: v for k, v in got.items() if not isinstance(v, (bool, str))}
    assert set(numeric) == set(want)
    for n, v in numeric.items():
        w = want[n]
        if isinstance(v, HostDD):
            flat = [float(v.hi), float(v.lo)]
        elif isinstance(v, tuple):
            flat = [float(v[0]), float(v[1].hi), float(v[1].lo)]
        else:
            flat = [float(v)]
        assert flat == list(w), n


def test_make_test_pulsar_matches_reference(ref):
    """The port's simulation of the bench pulsar lands on the reference's
    arrival times: same days, seconds within 1e-12 s (each package
    inverts with its own residuals, which agree to ~1e-15 s)."""
    _, toas = make_test_pulsar(
        BENCH_PAR, ntoa=512, start_mjd=53000.0, end_mjd=57500.0, seed=0,
        iterations=1, orbit=True, device="cpu",
    )
    np.testing.assert_array_equal(toas["tdb_day"], ref["sim/day"])
    dsec = (toas["tdb_sec_hi"] - ref["sim/hi"]) + (
        toas["tdb_sec_lo"] - ref["sim/lo"]
    )
    assert np.max(np.abs(dsec)) <= 1e-12
    np.testing.assert_allclose(
        toas["ssb_obs_pos_ls"], ref["bench/bundle/ssb_obs_pos_ls"],
        rtol=0, atol=1e-9,  # light-seconds; ~1e-15 s time offsets
    )


def test_host_fourier_basis_bitwise(ref):
    table = load_state(ref, "bench")["bundle"]
    F = host_fourier_basis(table, 30)
    np.testing.assert_array_equal(F, ref["bench/masks/pl_red_noise:F"])


@pytest.mark.parametrize("name", STATES)
def test_time_residuals_match_reference(ref, name):
    """Residuals on the same state agree to 1e-11 s (both packages run
    the same double-double algorithms in IEEE f64; the margin covers
    the transcendental libraries' last-ulp differences)."""
    cm = _compiled(ref, name)
    x0 = cm.x0()
    r = cm.time_residuals(x0).numpy()
    np.testing.assert_allclose(r, ref[f"res/{name}/resid"], rtol=0, atol=1e-11)
    r0 = cm.time_residuals(x0, subtract_mean=False).numpy()
    np.testing.assert_allclose(r0, ref[f"res/{name}/resid_nomean"], rtol=0,
                               atol=1e-11)


def test_golden13_residuals_match_oracle(ref):
    """golden13's committed oracle: < 1 ns, the golden regression bar."""
    oracle = np.load(DATADIR / "golden13_oracle.npz")
    cm = _compiled(ref, "golden13")
    r = cm.time_residuals(cm.x0()).numpy()
    np.testing.assert_allclose(r, oracle["resid"], rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", STATES)
def test_design_matrix_matches_jacfwd(ref, name):
    """torch.func.jacfwd through the custom-JVP DD cores against JAX's
    jacfwd: each column within 1e-9 of its own max."""
    cm = _compiled(ref, name)
    M = cm.design_matrix(cm.x0()).numpy()
    want = ref[f"res/{name}/design"]
    assert M.shape == want.shape
    scale = np.max(np.abs(want), axis=0)
    assert np.all(np.max(np.abs(M - want), axis=0) <= 1e-9 * scale)


@pytest.mark.parametrize("name", STATES)
def test_noise_inputs_match(ref, name):
    """scaled_sigma, the basis T and the weights phi: 1e-12 relative."""
    cm = _compiled(ref, name)
    x0 = cm.x0()
    np.testing.assert_allclose(cm.scaled_sigma(x0).numpy(),
                               ref[f"res/{name}/sigma"], rtol=1e-12, atol=0)
    T, phi = cm.noise_basis_or_empty(x0)
    np.testing.assert_allclose(T.numpy(), ref[f"res/{name}/T"], rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(phi.numpy(), ref[f"res/{name}/phi"], rtol=1e-12,
                               atol=0)


def test_state_round_trips_reference_values(ref):
    """state_from_numpy anchors x = 0 on exactly the exported values."""
    for name in STATES:
        state = load_state(ref, name)
        _, _, got = state_from_numpy(state, device="cpu")
        for n, v in state["ref"].items():
            g = got[n]
            if isinstance(g, HostDD):
                assert (float(g.hi), float(g.lo)) == v, n
            elif isinstance(g, tuple):
                assert (g[0], float(g[1].hi), float(g[1].lo)) == v, n
            else:
                assert g == v, n


@pytest.mark.parametrize("line", ["NE_SW 7.9 1", "GLEP_1 55000",
                                  "WAVE_OM 0.005", "UNITS TCB"])
def test_get_model_rejects_unported_lines(line):
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        get_model(BENCH_PAR + line + "\n")


def test_entry_points_need_a_card_unless_told(monkeypatch):
    """device=None means the card; without one the port raises instead of
    falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = get_model(BENCH_PAR)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_test_pulsar(BENCH_PAR, ntoa=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.compile({"freq_mhz": np.ones(2)})
