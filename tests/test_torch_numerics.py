"""Numerics of the PyTorch port: double-double, phase, Taylor, the f32
Gram/solve helpers and the fused joint Gram, held against mpmath and
against the JAX package on the same inputs.

The JAX side runs once per module in a subprocess
(tests/torch_reference.py) with ``PINT_TPU_FUSED_INTERIOR=force`` and
``PINT_TPU_SOLVE_IR=force``, so its ``fused_gram_joint`` runs the Pallas
kernel in interpret mode as tests/test_fused_interior.py does.  Inputs
come from ``np.random.default_rng`` and are handed to both packages.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import mpmath as mp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import (  # noqa: E402
    GRAM_CASES,
    REPO,
    dd_inputs,
    gram_inputs,
    run_reference,
)

from pint_tpu_torch.ops import solve_policy  # noqa: E402
from pint_tpu_torch.ops.dd import DD, dd_sqrt, dd_where  # noqa: E402
from pint_tpu_torch.ops.ffgram import (  # noqa: E402
    _check_poison,
    chol_solve_ir,
    gram32,
    gram32_joint,
    make_matmul_split32,
)
from pint_tpu_torch.ops.fused_gram import (  # noqa: E402
    fused_block_table,
    fused_tile_count,
    fused_gram_joint,
    fused_gram_joint_cuda,
    fused_gram_joint_plain,
)
from pint_tpu_torch.ops.phase import Phase  # noqa: E402
from pint_tpu_torch.ops.taylor import (  # noqa: E402
    taylor_horner,
    taylor_horner_dd,
    taylor_horner_deriv_dd,
)

F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


_SCRIPT = textwrap.dedent("""
import jax
import jax.numpy as jnp
from pint_tpu.ops.dd import DD, dd_sqrt
from pint_tpu.ops.taylor import taylor_horner_dd
from pint_tpu.ops.ffgram import (
    chol_solve_ir, gram32, gram32_joint, matmul_split32)
from pint_tpu.ops.pallas_fit import fused_gram_joint
import torch_reference as tn

a, la, b, lb = tn.dd_inputs()
x, y = DD(jnp.asarray(a), jnp.asarray(la)), DD(jnp.asarray(b), jnp.asarray(lb))
for name, v in (("add", x + y), ("mul", x * y), ("div", x / y),
                ("sqrt", dd_sqrt(DD(jnp.abs(x.hi), jnp.abs(x.hi) * 1e-17))),
                ("from_sum", DD.from_sum(a, b)),
                ("from_prod", DD.from_prod(a, b))):
    OUT[f"dd/{name}"] = np.stack([np.asarray(v.hi), np.asarray(v.lo)])

# spin phase and its tangent through the custom JVPs
dt = DD.from_sum(jnp.linspace(-3e8, 3e8, 33), jnp.linspace(0, 1e-9, 33))
def ph(d):
    c = [0.0, DD(jnp.float64(245.4261196898081), jnp.float64(-3.9e-15)) + d[0],
         -5.38e-16 + d[1], 1e-27]
    return taylor_horner_dd(dt, c)
v = ph(jnp.zeros(2))
OUT["taylor/val"] = np.stack([np.asarray(v.hi), np.asarray(v.lo)])
OUT["taylor/jac"] = np.asarray(jax.jacfwd(lambda d: ph(d).to_float())(
    jnp.zeros(2)))

for n, k in tn.GRAM_CASES:
    T, A, w = tn.gram_inputs(n, k)
    Gs = fused_gram_joint(jnp.asarray(T, jnp.float32), jnp.asarray(A),
                          jnp.asarray(w))
    Gu = gram32_joint(jnp.asarray(T, jnp.float32), jnp.asarray(A),
                      jnp.asarray(w))
    for name, G in (("fused", Gs), ("joint", Gu)):
        for part, g in zip(("tt", "ta", "aa"), G):
            OUT[f"{name}/{n}/{k}/{part}"] = np.asarray(g)
T, A, w = tn.gram_inputs(1000, 60)
OUT["gram32"] = np.asarray(gram32(jnp.asarray(A), jnp.asarray(w)))
rng = np.random.default_rng(3)
B = rng.standard_normal((300, 5))
C = rng.standard_normal((5, 300))
OUT["split32"] = np.asarray(matmul_split32(jnp.asarray(C), jnp.asarray(B)))
S = T.T @ (T * w[:, None]) + np.diag(np.logspace(-4, 6, 60))
OUT["chol_ir"] = np.asarray(chol_solve_ir(jnp.asarray(S), jnp.asarray(B[:60]),
                                          check_rtol=1e-5))
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(
        _SCRIPT, tmp_path_factory.mktemp("ref") / "numerics.npz",
        env={"PINT_TPU_FUSED_INTERIOR": "force",
             "PINT_TPU_SOLVE_IR": "force"},
    )


@pytest.fixture(autouse=True)
def _dps():
    with mp.workdps(50):
        yield


def to_mp(x: DD, i=None) -> mp.mpf:
    hi, lo = (x.hi, x.lo) if i is None else (x.hi[i], x.lo[i])
    return mp.mpf(float(hi)) + mp.mpf(float(lo))


def _close(x, ref, tol, i):
    err = abs(to_mp(x, i) - ref)
    assert err <= tol, (to_mp(x, i), ref, err)


# -- double-double against mpmath ----------------------------------------
def test_dd_arithmetic_matches_mpmath():
    """add/sub/mul/div/sqrt to 1e-29 relative (the JAX package's bar)."""
    a, la, b, lb = dd_inputs()
    x = DD(_t(a), _t(la))
    y = DD(_t(b), _t(lb))
    xs = DD(torch.abs(x.hi), torch.abs(x.hi) * 1e-17)
    for i in range(len(a)):
        ma = mp.mpf(a[i]) + mp.mpf(la[i])
        mb = mp.mpf(b[i]) + mp.mpf(lb[i])
        # a sum is exact to 1e-29 of its operands' size
        _close(x + y, ma + mb, 1e-29 * (abs(ma) + abs(mb)), i)
        _close(x * y, ma * mb, 1e-29 * abs(ma * mb), i)
        _close(x / y, ma / mb, 4e-29 * abs(ma / mb), i)
        ms = mp.mpf(float(xs.hi[i])) + mp.mpf(float(xs.lo[i]))
        _close(dd_sqrt(xs), mp.sqrt(ms), 4e-29 * mp.sqrt(ms), i)


def test_dd_catastrophic_cancellation_exact():
    """(a + tiny) - a recovers tiny exactly."""
    a = DD.from_sum(_t([1e9, -3e8]), _t([1e-9, 2.5e-10]))
    d = (a - DD.from_float(_t([1e9, -3e8]))).to_float()
    assert d.tolist() == [1e-9, 2.5e-10]


def test_dd_from_sum_prod_exact():
    a, _, b, _ = dd_inputs()
    s = DD.from_sum(_t(a), _t(b))
    p = DD.from_prod(_t(a), _t(b))
    for i in range(len(a)):
        assert to_mp(s, i) == mp.mpf(a[i]) + mp.mpf(b[i])
        assert to_mp(p, i) == mp.mpf(a[i]) * mp.mpf(b[i])


def test_dd_where_and_negation():
    x = DD(_t([-2.0, 3.0]), _t([-1e-17, 1e-17]))
    y = dd_where(x.hi > 0, x, -x)
    assert y.hi.tolist() == [2.0, 3.0]
    assert y.lo.tolist() == [1e-17, 1e-17]


def test_time_precision_over_decades():
    """20 yr of seconds plus 1 ns survives round trips at ~1e-20 s."""
    t = DD.from_sum(6.3e8, 1e-9)
    d = (t - 6.3e8).to_float()
    assert abs(float(d) - 1e-9) < 1e-20


def test_split_int_frac_and_phase():
    x = DD.from_sum(_t([1e12 + 0.5, -7.25, 3.0]), _t([1e-7, 0.0, -1e-20]))
    ph = Phase.from_dd(x)
    for i, (hi, lo) in enumerate([(1e12 + 0.5, 1e-7), (-7.25, 0.0),
                                  (3.0, -1e-20)]):
        total = mp.mpf(hi) + mp.mpf(lo)
        assert -0.5 <= float(ph.frac[i]) < 0.5
        err = abs(mp.mpf(float(ph.int_[i])) + mp.mpf(float(ph.frac[i])) - total)
        assert err < 1e-15
    s = ph + Phase.from_float(0.75)
    assert torch.all((s.frac >= -0.5) & (s.frac < 0.5))
    d = (s - ph).to_float()
    assert torch.allclose(d, torch.full_like(d, 0.75), rtol=0, atol=1e-12)


def test_taylor_horner_matches_mpmath():
    """Spin phase over +-10 yr to < 1e-12 cycles (sub-ns), against
    mpmath with the DD inputs taken exactly."""
    dt = DD.from_sum(torch.linspace(-3e8, 3e8, 17, dtype=F64),
                     torch.linspace(0, 1e-9, 17, dtype=F64))
    f0 = DD(_t(245.4261196898081), _t(-3.9e-15))
    coeffs = [0.0, f0, -5.38e-16, 1e-27]
    v = taylor_horner_dd(dt, coeffs)
    d1 = taylor_horner_deriv_dd(dt, coeffs, 1)
    for i in range(17):
        t = mp.mpf(float(dt.hi[i])) + mp.mpf(float(dt.lo[i]))
        mf0 = mp.mpf(245.4261196898081) + mp.mpf(-3.9e-15)
        want = mf0 * t + mp.mpf(-5.38e-16) * t**2 / 2 + mp.mpf(1e-27) * t**3 / 6
        assert abs(to_mp(v, i) - want) < 1e-12
        want1 = mf0 + mp.mpf(-5.38e-16) * t + mp.mpf(1e-27) * t**2 / 2
        assert abs(to_mp(d1, i) - want1) < 1e-20
    plain = taylor_horner(torch.tensor([2.0], dtype=F64), [1.0, 2.0, 6.0])
    assert plain.tolist() == [1.0 + 4.0 + 12.0]


# -- against the JAX ops ---------------------------------------------------
def test_dd_ops_bitwise_equal_to_jax(ref):
    """The same error-free transforms in IEEE f64 with no contraction:
    every DD op agrees with the JAX package bit for bit."""
    a, la, b, lb = dd_inputs()
    x, y = DD(_t(a), _t(la)), DD(_t(b), _t(lb))
    got = {
        "add": x + y, "mul": x * y, "div": x / y,
        "sqrt": dd_sqrt(DD(torch.abs(x.hi), torch.abs(x.hi) * 1e-17)),
        "from_sum": DD.from_sum(_t(a), _t(b)),
        "from_prod": DD.from_prod(_t(a), _t(b)),
    }
    for name, v in got.items():
        w = ref[f"dd/{name}"]
        np.testing.assert_array_equal(v.hi.numpy(), w[0], err_msg=name)
        np.testing.assert_array_equal(v.lo.numpy(), w[1], err_msg=name)


def test_taylor_and_jacfwd_match_jax(ref):
    """Primal phase bitwise; the jacfwd tangents through the custom-JVP
    cores to 1e-15 relative (plain-f64 tangent arithmetic)."""
    dt = DD.from_sum(torch.linspace(-3e8, 3e8, 33, dtype=F64),
                     torch.linspace(0, 1e-9, 33, dtype=F64))

    def ph(d):
        c = [0.0, DD(_t(245.4261196898081), _t(-3.9e-15)) + d[0],
             -5.38e-16 + d[1], 1e-27]
        return taylor_horner_dd(dt, c)

    v = ph(torch.zeros(2, dtype=F64))
    np.testing.assert_array_equal(v.hi.numpy(), ref["taylor/val"][0])
    np.testing.assert_array_equal(v.lo.numpy(), ref["taylor/val"][1])
    J = jacfwd(lambda d: ph(d).to_float())(torch.zeros(2, dtype=F64))
    np.testing.assert_allclose(J.numpy(), ref["taylor/jac"], rtol=1e-15,
                               atol=0)


def test_f32_gram_helpers_match_jax(ref):
    """gram32, gram32_joint and the split-f32 matmul: 1e-6 of scale (both
    accumulate f32 chunk partials in f64; the within-chunk order differs
    between the two libraries)."""
    T, A, w = gram_inputs(1000, 60)
    G = gram32(_t(A), _t(w)).numpy()
    want = ref["gram32"]
    assert np.max(np.abs(G - want)) <= 1e-6 * np.max(np.abs(want))
    for n, k in GRAM_CASES:
        T, A, w = gram_inputs(n, k)
        got = gram32_joint(torch.as_tensor(T, dtype=torch.float32), _t(A),
                           _t(w))
        for part, g in zip(("tt", "ta", "aa"), got):
            want = ref[f"joint/{n}/{k}/{part}"]
            assert np.max(np.abs(g.numpy() - want)) <= 1e-6 * np.max(
                np.abs(want)
            )
    rng = np.random.default_rng(3)
    B = rng.standard_normal((300, 5))
    C = rng.standard_normal((5, 300))
    got = make_matmul_split32(_t(C))(_t(B)).numpy()
    scale = np.max(np.abs(C @ B))
    assert np.max(np.abs(got - ref["split32"])) <= 1e-6 * scale
    assert np.max(np.abs(got - C @ B)) <= 1e-6 * scale


def test_chol_solve_ir_matches_jax(ref):
    """Equilibrated f32 Cholesky + two f64 refinements on a system with
    1e10 diagonal dynamic range: 1e-9 relative, residual check armed."""
    T, A, w = gram_inputs(1000, 60)
    rng = np.random.default_rng(3)
    B = rng.standard_normal((300, 5))
    S = T.T @ (T * w[:, None]) + np.diag(np.logspace(-4, 6, 60))
    X = chol_solve_ir(_t(S), _t(B[:60]), check_rtol=1e-5).numpy()
    want = ref["chol_ir"]
    assert np.all(np.isfinite(X))
    assert np.max(np.abs(X - want)) <= 1e-9 * np.max(np.abs(want))


def test_check_poison_nans_a_stalled_solve():
    X = torch.ones(3, 2, dtype=F64)
    B = torch.ones(3, 2, dtype=F64)
    assert torch.all(torch.isnan(_check_poison(X, B * 1e-3, B, 1e-5)))
    assert torch.equal(_check_poison(X, B * 1e-7, B, 1e-5), X)
    zero = torch.zeros(3, 2, dtype=F64)
    assert torch.equal(_check_poison(X, zero, zero, 1e-5), X)


@pytest.mark.parametrize("n,k", GRAM_CASES)
def test_fused_gram_plain_matches_pallas_interpret(ref, n, k):
    """The kernel's plain version against the reference Pallas kernel in
    interpret mode: 3e-6 of scale (the test_fused_interior.py bound; both
    are 128-row f32 chunk sums combined in f64 or compensated f32)."""
    T, A, w = gram_inputs(n, k)
    got = fused_gram_joint_plain(torch.as_tensor(T, dtype=torch.float32),
                                 _t(A), _t(w))
    for part, g in zip(("tt", "ta", "aa"), got):
        want = ref[f"fused/{n}/{k}/{part}"]
        assert g.dtype == F64 and g.shape == want.shape
        scale = np.max(np.abs(want))
        assert np.max(np.abs(g.numpy() - want)) <= 3e-6 * scale, part


@pytest.mark.parametrize("n,k", GRAM_CASES)
def test_fused_gram_zero_weight_padding_exact(n, k):
    """Rows with zero weight contribute exactly zero: padding the input
    with them leaves every output bit unchanged."""
    T, A, w = gram_inputs(n, k)
    pad = 300
    Tp = np.concatenate([T, np.ones((pad, k))])
    Ap = np.concatenate([A, np.ones((pad, A.shape[1]))])
    wp = np.concatenate([w, np.zeros(pad)])
    base = fused_gram_joint(_t(T), _t(A), _t(w))
    padded = fused_gram_joint(_t(Tp), _t(Ap), _t(wp))
    for g0, g1 in zip(base, padded):
        assert torch.equal(g0, g1)


def test_fused_gram_f64_basis_is_cast_in_place():
    """T given in f64 is the same function as T given in f32."""
    T, A, w = gram_inputs(1000, 60)
    a = fused_gram_joint(_t(T), _t(A), _t(w))
    b = fused_gram_joint(torch.as_tensor(T, dtype=torch.float32), _t(A),
                         _t(w))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_fused_block_table():
    """Pure function of the shapes; the bench shape and golden13's k = 1
    empty basis are on the narrow path (one persistent block per SM, 132,
    64-row chunks, Y padded to whole 16-column bands), q = k + p1 > 80 on
    the wide path (row runs of its tile groups, Y in whole 16-column
    bands, 384 threads), and only what the reference's table refuses
    (pad128(k) + pad128(p1) > 640) is out."""
    tab = fused_block_table(100_000, 60, 7)
    assert tab == fused_block_table(100_000, 60, 7)
    nb, q_pad, threads = tab
    assert q_pad == 80 and threads == 512 and nb == 132
    assert fused_block_table(92, 1, 9) == (2, 16, 512)
    assert fused_block_table(1000, 1, 3)[1] == 16
    assert fused_block_table(10, 72, 8) == (1, 80, 512)
    assert fused_block_table(10, 73, 8) == (1, 96, 384)
    assert fused_block_table(100_000, 60, 169) == (44, 240, 384)
    assert fused_block_table(100_000, 128, 512) == (6, 640, 384)
    assert fused_block_table(100_000, 129, 512) is None
    assert fused_block_table(0, 60, 7) is None


@pytest.mark.parametrize("q", range(1, 81))
def test_fused_tiles_cover_the_upper_triangle(q):
    """The kernel's 16 x 8 output tiles (bands I, column tiles J >= 2 I,
    fused_tile_count of them) cover each element (a, c), a <= c < q, of
    the upper triangle exactly once, and fit the kernel's 8 MMA warps of
    at most 6 tiles."""
    nt, nbt = -(-q // 8), -(-q // 16)
    tiles = [(i, j) for i in range(nbt) for j in range(2 * i, nt)]
    assert len(tiles) == fused_tile_count(q) <= 8 * 6
    seen = np.zeros((q, q), dtype=int)
    for i, j in tiles:
        for a in range(16 * i, min(16 * i + 16, q)):
            for c in range(8 * j, min(8 * j + 8, q)):
                if a <= c:
                    seen[a, c] += 1
    assert np.array_equal(seen, np.triu(np.ones((q, q), dtype=int)))


def test_fused_gram_dispatch_and_contract():
    """CPU tensors take the plain version (no launch counted); the CUDA
    wrapper refuses CPU tensors; an unknown precision rung raises."""
    T, A, w = gram_inputs(1000, 1)
    before = fused_gram_joint_cuda.launches
    fused_gram_joint(_t(T), _t(A), _t(w))
    assert fused_gram_joint_cuda.launches == before
    with pytest.raises(ValueError, match="one card"):
        fused_gram_joint_cuda(_t(T), _t(A), _t(w))
    with pytest.raises(ValueError, match="unknown precision"):
        fused_gram_joint(_t(T), _t(A), _t(w), precision="medium")


def _refusal_cases():
    """(name, (T, A, w), exception, message) for every input the kernel's
    design cannot take; each is refused before the device is looked at."""
    T, A, w = (_t(x) for x in gram_inputs(1000, 4))
    flat = torch.zeros(2 * 1000 * 4 + 1, dtype=F64)
    return [
        ("T f16", (T.half(), A, w), TypeError, "T f32/f64"),
        ("A f32", (T, A.float(), w), TypeError, "A f64"),
        ("w 2-d", (T, A, w[:, None]), ValueError, r"w \(n,\)"),
        ("rows differ", (T[:999], A, w), ValueError, "row counts differ"),
        ("T strided", (T[:, ::2], A, w), ValueError, "contiguous"),
        ("T 8 bytes off", (flat[1:4001].reshape(1000, 4), A, w), ValueError,
         "16-byte"),
        ("q = 641", (torch.zeros(1000, 129, dtype=F64),
                     torch.zeros(1000, 512, dtype=F64), w), ValueError,
         "outside fused_block_table"),
        ("n = 0", (T[:0], A[:0], w[:0]), ValueError,
         "outside fused_block_table"),
    ]


@pytest.mark.parametrize("case", range(8))
def test_fused_gram_cuda_refuses_what_the_kernel_cannot_take(case):
    """The CUDA wrapper's checks of types, shapes, contiguity, 16-byte
    alignment (the bulk copies') and the block table need no card: on CPU
    tensors they raise, naming the reason, before the device check, and
    count no launch."""
    name, args, exc, msg = _refusal_cases()[case]
    before = fused_gram_joint_cuda.launches
    with pytest.raises(exc, match=msg):
        fused_gram_joint_cuda(*args)
    assert fused_gram_joint_cuda.launches == before, name


def test_solve_policy_knobs(monkeypatch):
    """CPU keeps the exact paths, CUDA takes the mixed ones; '0' turns
    the policy off everywhere and 'force' on everywhere."""
    monkeypatch.delenv("PINT_TPU_TORCH_SOLVE_IR", raising=False)
    monkeypatch.delenv("PINT_TPU_TORCH_FUSED_INTERIOR", raising=False)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert not solve_policy.ir_active(cpu) and solve_policy.ir_active(cuda)
    assert solve_policy.check_rtol(cpu) is None
    assert solve_policy.check_rtol(cuda) == solve_policy.DEFAULT_CHECK_RTOL
    assert solve_policy.fused_interior_active(cuda)
    assert not solve_policy.fused_interior_active(cpu)
    with solve_policy.fused_interior_bypass():
        assert not solve_policy.fused_interior_active(cuda)
    monkeypatch.setenv("PINT_TPU_TORCH_SOLVE_IR", "0")
    monkeypatch.setenv("PINT_TPU_TORCH_FUSED_INTERIOR", "0")
    assert not solve_policy.ir_active(cuda)
    assert not solve_policy.fused_interior_active(cuda)
    monkeypatch.setenv("PINT_TPU_TORCH_SOLVE_IR", "force")
    monkeypatch.setenv("PINT_TPU_TORCH_FUSED_INTERIOR", "force")
    assert solve_policy.ir_active(cpu)
    assert solve_policy.fused_interior_active(cpu)


# -- the port stands alone -------------------------------------------------
def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "pint_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    names = {f.relative_to(REPO).as_posix() for f in files}
    assert {"pint_tpu_torch/parallel/dense.py",
            "pint_tpu_torch/ops/cholupdate.py"} <= names
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "pint_tpu"), (f, mod)


def test_importing_the_port_loads_no_jax():
    code = textwrap.dedent("""
        import sys, importlib, pkgutil
        import pint_tpu_torch
        for m in pkgutil.walk_packages(pint_tpu_torch.__path__,
                                       "pint_tpu_torch."):
            importlib.import_module(m.name)
        assert "jax" not in sys.modules, "jax was imported"
        assert not any(k == "pint_tpu" or k.startswith("pint_tpu.")
                       for k in sys.modules), "pint_tpu was imported"
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


# -- on the card -----------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("n,k,p1,t32", [
    (100_000, 60, 7, False), (100_000, 60, 7, True), (1000, 1, 3, False),
    (92, 1, 9, False), (100_000, 64, 16, False), (100_001, 61, 7, False),
    (100_001, 61, 7, True)])
def test_fused_gram_kernel_matches_plain_on_card(n, k, p1, t32):
    """The CUDA kernel against its plain version on the same card
    tensors: 3e-6 of scale, and bitwise equal to itself on a rerun.  The
    shapes are the bench's (T in f64 and f32), k = 1 (golden13's empty
    basis) with one or two chunks, the widest q = 80, and a ragged n
    whose last T, A and w spans are not whole 16-byte units."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    T = torch.as_tensor(rng.standard_normal((n, k)), device=dev)
    if t32:
        T = T.float()
    A = torch.as_tensor(rng.standard_normal((n, p1)), device=dev)
    w = torch.as_tensor(rng.uniform(0.5, 2.0, n), device=dev)
    got = fused_gram_joint_cuda(T, A, w)
    again = fused_gram_joint_cuda(T, A, w)
    want = fused_gram_joint_plain(T, A, w)
    for g, g2, ww in zip(got, again, want):
        assert torch.equal(g, g2)
        scale = float(torch.max(torch.abs(ww)))
        assert float(torch.max(torch.abs(g - ww))) <= 3e-6 * scale
