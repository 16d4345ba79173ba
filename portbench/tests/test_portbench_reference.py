"""The plain reference against the port's CPU path on small copies of
each configuration, its control in float32, and the import boundary.

The tests may import the port; the reference and the inputs may not."""

import ast
from pathlib import Path

import numpy as np
import pytest

from conftest import small_config, small_offsets
from portbench.calibrate import control_inputs
from portbench.compare import gaps, input_gaps, reference_fit
from portbench.inputs.simulate import simulate, start_par
from portbench.reference.model import ReferenceModel

BENCH = Path(__file__).resolve().parents[1]
CONFIGS = ["msp_rn_1e5", "msp_ecorr_8k"]
#: the cells' steps a fit (``maxiter``, with no chi2 test)
STEPS = 4


def _inputs(name, seed=2 ** 31 + 77):
    from portbench import harness

    cell = next(c for c in ("msp_rn_1e5.gls", "msp_ecorr_8k.dense")
                if c.startswith(name))
    truth, table = simulate(small_config(name), seed)
    offsets = harness.load_json("cells", cell)["start"]["offsets"]
    return start_par(truth, small_offsets(offsets), seed), table


@pytest.fixture(scope="module", params=CONFIGS)
def case(request):
    from pint_tpu_torch.fitting.base import design_with_offset
    from pint_tpu_torch.models.builder import get_model

    par, table = _inputs(request.param)
    ref = ReferenceModel(par, table)
    cm = get_model(par).compile(table, device="cpu", subtract_mean=False)
    perm = [list(cm.free_names).index(n) for n in ref.free]
    x0 = cm.x0()
    return dict(par=par, table=table, ref=ref, cm=cm, perm=perm,
                r=cm.time_residuals(x0, subtract_mean=False).numpy(),
                M=design_with_offset(cm, x0).numpy()[
                    :, [0] + [1 + i for i in perm]])


def test_same_free_parameters(case):
    assert sorted(case["cm"].free_names) == sorted(case["ref"].free)


def test_residuals_agree(case):
    r = case["ref"].residuals(np.zeros(len(case["ref"].free)))
    assert np.max(np.abs(case["r"] - r)) < 1e-12


def test_design_matrix_agrees(case):
    M = case["ref"].design(np.zeros(len(case["ref"].free)))
    scale = np.max(np.abs(M), axis=0)
    assert np.max(np.abs(case["M"] - M) / scale) < 1e-8


def test_noise_model_agrees(case):
    cm, ref = case["cm"], case["ref"]
    x0 = cm.x0()
    sigma, T, phi = ref.noise()
    np.testing.assert_allclose(cm.scaled_sigma(x0).numpy(), sigma,
                               rtol=1e-15, atol=0)
    Tp, phip = (a.numpy() for a in cm.noise_basis(x0))
    assert Tp.shape == T.shape
    Cp = (Tp * phip) @ Tp.T
    C = (T * phi) @ T.T
    assert np.max(np.abs(Cp - C)) < 1e-12 * np.max(np.abs(C))


def _program(par, table, full_cov):
    from portbench.harness import Program

    cell = {"fitter": {"full_cov": full_cov, "maxiter": STEPS,
                       "tol_chi2": 0.0}}
    return Program(par, table, cell, "cpu")


def _port_answer(par, table, full_cov):
    prog = _program(par, table, full_cov)
    return prog.answer(prog.fit())


@pytest.mark.parametrize("full_cov", [False, True])
def test_fit_agrees(case, full_cov):
    ref = reference_fit(case["par"], case["table"], STEPS)
    g = gaps(_port_answer(case["par"], case["table"], full_cov), ref)
    assert g["param_gap_sigma"] < 1e-4
    assert g["cov_gap"] < 1e-5
    assert g["chi2_gap"] < 1e-8


def test_step_inputs_agree(case):
    """The inputs the harness brings back from the fitter's own hooks
    match the reference's first step: residuals to 1e-5 sigma, the
    design matrix to 1e-9 of each column, the noise model to 1e-12."""
    ref = reference_fit(case["par"], case["table"], 1)
    got = _program(case["par"], case["table"], False).step_inputs()
    g = input_gaps(got, ref)
    assert g["resid_gap_sigma"] < 1e-5, g
    assert g["design_gap"] < 1e-9, g
    assert g["noise_gap"] < 1e-12, g


def test_control_inputs_are_further_off(case):
    """The control's inputs (phase in float64, design and noise rounded
    to float32) read at least ten times the port's gaps."""
    ref = reference_fit(case["par"], case["table"], 1)
    port = input_gaps(_program(case["par"], case["table"], False)
                      .step_inputs(), ref)
    ctrl = input_gaps(control_inputs(case["par"], case["table"], ref), ref)
    for k in ("resid_gap_sigma", "design_gap", "noise_gap"):
        assert ctrl[k] > 10 * port[k], (k, ctrl[k], port[k])


def test_control_in_float32_is_further_off(case):
    """The reference's float32 control reads at least ten times the f64
    port's gap on every number the cells compare, here at small size."""
    ref = reference_fit(case["par"], case["table"], STEPS)
    port = gaps(_port_answer(case["par"], case["table"], False), ref)
    ctrl = gaps(reference_fit(case["par"], case["table"], STEPS,
                              dtype=np.float32), ref)
    for k in ("param_gap_sigma", "cov_gap"):
        assert ctrl[k] > 10 * port[k], (k, ctrl[k], port[k])


@pytest.mark.parametrize("cell", ["msp_rn_1e5.gls",
                                  "msp_ecorr_8k.dense"])
def test_control_comes_out_not_correct(cell):
    """The control (the reference's step in float32, put in the
    program's place) fails at least one of the cell's limits."""
    from portbench import harness

    limits = harness.load_json("cells", cell)["limits"]
    par, table = _inputs(cell.split(".")[0])
    ref = reference_fit(par, table, STEPS)
    ctrl = dict(gaps(reference_fit(par, table, STEPS, dtype=np.float32),
                     ref), **input_gaps(control_inputs(par, table, ref), ref))
    assert any(ctrl[k] > v for k, v in limits.items()), ctrl


def test_same_seed_same_inputs():
    a = simulate(small_config("msp_rn_1e5"), 2 ** 31 + 5)[1]
    b = simulate(small_config("msp_rn_1e5"), 2 ** 31 + 5)[1]
    c = simulate(small_config("msp_rn_1e5"), 2 ** 31 + 6)[1]
    for k in ("tdb_day", "tdb_sec_hi", "tdb_sec_lo"):
        assert np.array_equal(a[k], b[k])
    assert not np.array_equal(a["tdb_sec_hi"], c["tdb_sec_hi"])


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        bad = _imports(path) & {"jax", "jaxlib", "flax", "pint_tpu"}
        assert not bad, (path, bad)


@pytest.mark.parametrize("sub", ["reference", "inputs", "metrics"])
def test_reference_side_imports_nothing_of_the_port(sub):
    for path in (BENCH / sub).rglob("*.py"):
        names = _imports(path)
        assert "pint_tpu_torch" not in names, path
        assert "torch" not in names, path

