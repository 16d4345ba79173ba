"""The two Gram kernels at the reference's shapes (q = k + p1 up to 640;
any k, p and m for the Fourier kernels).

The port's ``fused_block_table`` admits a shape exactly when the
reference's does (``pint_tpu/ops/pallas_fit.py``, run in the reference
subprocess of tests/torch_reference.py); ``_joint_gram`` then takes the
fused route for the binary MSP's q = 229 and ``gram32_joint`` only where
the reference's table refuses; the wide kernel's schedule
(``wide_geometry``) covers each live output tile once, balanced, within
shared memory and with aligned copies; the plain versions hold the reference's
Pallas kernels (interpret mode, as its own tests run them) at q = 228 and
229, k = 100 with p = 169 and m = 40; the column-sliced Fourier dispatch
gives the bits of one launch.  The ``gpu`` tests hold the CUDA kernels to
their plain versions on the card and skip without one.
"""

import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import (  # noqa: E402
    fourier_inputs,
    gram_inputs,
    run_reference,
)

import pint_tpu_torch.ops.fused_gram as fused_gram  # noqa: E402
from pint_tpu_torch.fitting import gls  # noqa: E402
from pint_tpu_torch.ops import fourier  # noqa: E402
from pint_tpu_torch.ops.fused_gram import (  # noqa: E402
    fused_block_table,
    fused_gram_joint_cuda,
    fused_gram_joint_plain,
)

F64 = torch.float64
#: the shape grid of the table test (n = 1e5)
TABLE_K = [1, 60, 64, 127, 128, 129, 200, 256, 384, 512, 639, 640]
TABLE_P1 = [1, 7, 128, 129, 168, 169, 256, 384, 511, 512, 513, 640]
#: (n, k, p1) of the plain-vs-Pallas joint Gram cases
JOINT_CASES = [(1000, 60, 168), (1000, 60, 169), (517, 128, 512)]
#: (n, k, p) and (n, k, m) of the Fourier cases
FOURIER_GRAM = [(600, 100, 169), (600, 30, 169)]
FOURIER_APPLY = [(600, 100, 40)]


_SCRIPT = textwrap.dedent(f"""
import jax.numpy as jnp
import torch_reference as tr
from pint_tpu.ops.pallas_fit import fused_block_table, fused_gram_joint
from pint_tpu.ops.pallas_kernels import fourier_apply, fourier_gram

OUT["table"] = np.array([[fused_block_table(100_000, k, p1) is not None
                          for p1 in {TABLE_P1!r}] for k in {TABLE_K!r}])
for n, k, p1 in {JOINT_CASES!r}:
    T, A, w = tr.gram_inputs(n, k, p1)
    G = fused_gram_joint(jnp.asarray(T, jnp.float32), jnp.asarray(A),
                         jnp.asarray(w))
    for part, g in zip(("tt", "ta", "aa"), G):
        OUT[f"joint/{{n}}/{{k}}/{{p1}}/{{part}}"] = np.asarray(g)
for n, k, p in {FOURIER_GRAM!r}:
    t, f, w, X = tr.fourier_inputs(n, k, p)
    sig, twx = fourier_gram(jnp.asarray(t), jnp.asarray(f), jnp.asarray(w),
                            jnp.asarray(X))
    OUT[f"gram/{{n}}/{{k}}/{{p}}/sig"] = np.asarray(sig)
    OUT[f"gram/{{n}}/{{k}}/{{p}}/twx"] = np.asarray(twx)
for n, k, m in {FOURIER_APPLY!r}:
    t, f, _, _ = tr.fourier_inputs(n, k, 1)
    z = np.random.default_rng(9).normal(size=(2 * k, m))
    OUT[f"apply/{{n}}/{{k}}/{{m}}"] = np.asarray(
        fourier_apply(jnp.asarray(t), jnp.asarray(f), jnp.asarray(z)))
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(_SCRIPT, tmp_path_factory.mktemp("ref") / "wide.npz")


def _t(x, device="cpu"):
    return torch.as_tensor(np.asarray(x), dtype=F64, device=device)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("k", TABLE_K)
def test_fused_block_table_admits_what_the_reference_admits(ref, k):
    """For each p1 of the grid (60/168, 128/512, 129/1 and 1/640 among
    them) the port's table gives a geometry exactly when the reference's
    gives a block size: pad128(k) + pad128(p1) <= 640."""
    got = [fused_block_table(100_000, k, p1) is not None for p1 in TABLE_P1]
    want = list(ref["table"][TABLE_K.index(k)])
    assert got == want


def test_wide_shapes_take_the_wide_path():
    """q > 80 has the wide path's geometry (row runs, Y's width in 16-column
    bands, 384 threads); the q <= 80 geometry of the narrow kernel is
    unchanged."""
    assert fused_block_table(100_000, 60, 7) == (132, 80, 512)
    assert fused_block_table(100_000, 60, 169) == (44, 240, 384)
    assert fused_block_table(100_000, 60, 168)[1:] == (240, 384)
    assert fused_block_table(64, 128, 512) == (4, 640, 384)


def _decoded(q):
    """wide_geometry(q)'s table as the kernel reads it: per group, its
    bands and per MMA warp (row bands, column bands, mask), each slot
    checked against the group's bands."""
    geo = fused_gram.wide_geometry(q)
    R, C = fused_gram.TASK_ROWS, fused_gram.TASK_COLS
    groups = []
    for row in geo["table"]:
        nbg = int(row[0])
        bands = [int(b) for b in row[1:1 + nbg]]
        warps = []
        for v in range(fused_gram.WIDE_MMA_WARPS):
            t = [int(x) for x in row[1 + fused_gram.NBG_MAX
                                     + v * fused_gram.TASK_INTS:][
                :fused_gram.TASK_INTS]]
            rb, cb, slots, mask = t[:R], t[R:R + C], t[R + C:-1], t[-1]
            for b, sl in zip(rb + cb, slots):
                assert (sl == -1) if b < 0 else bands[sl] == b
            warps.append((rb, cb, mask))
        groups.append((bands, warps))
    return geo, groups


WIDE_Q = [81, 96, 97, 128, 160, 200, 228, 229, 231, 300, 333, 400, 512,
          639, 640]


@pytest.mark.parametrize("q", WIDE_Q)
def test_wide_tiles_owned_once(q):
    """Every live 16 x 8 tile of the upper triangle (band I, column tile
    2 I <= J < ceil(q / 8)) is owned by exactly one (group, MMA warp, task
    slot) of the schedule table, and a group's bands are those its warps
    use."""
    geo, groups = _decoded(q)
    nbt, nt = -(-q // 16), -(-q // 8)
    seen = {}
    R, C = fused_gram.TASK_ROWS, fused_gram.TASK_COLS
    for g, (bands, warps) in enumerate(groups):
        used = set()
        for v, (rb, cb, mask) in enumerate(warps):
            for i in range(R):
                for j in range(C):
                    for h in range(2):
                        if mask >> ((i * C + j) * 2 + h) & 1:
                            tile = (rb[i], 2 * cb[j] + h)
                            seen[tile] = seen.get(tile, 0) + 1
                            used |= {rb[i], cb[j]}
        assert sorted(used) == bands
    live = {(i, j) for i in range(nbt) for j in range(2 * i, nt)}
    assert set(seen) == live and set(seen.values()) == {1}
    assert len(live) == fused_gram.fused_tile_count(q)
    assert geo["ngroups"] * (fused_gram.NB_MAX // geo["ngroups"]) <= 132


@pytest.mark.parametrize("q", WIDE_Q)
def test_wide_groups_balanced(q):
    """The tile groups' live tiles (MMAs a 16-row step) differ by at most
    one task's (12), and no warp scheduler of a block (warps p and p + 4)
    holds more than the mean a scheduler plus one task: the stated
    balance of ops/fused_gram.py::wide_geometry."""
    geo, groups = _decoded(q)
    task = fused_gram.TASK_ROWS * fused_gram.TASK_COLS * 2
    tiles = [sum(bin(m).count("1") for _, _, m in warps)
             for _, warps in groups]
    assert len(tiles) == geo["ngroups"]
    assert max(tiles) - min(tiles) <= task
    mean = sum(tiles) / (4 * len(tiles))
    for _, warps in groups:
        for p in range(4):
            load = sum(bin(warps[v][2]).count("1") for v in (p, p + 4))
            assert load <= mean + task


def test_wide_chunks_fit_shared_memory():
    """For every shape the reference admits past q = 80, with T in f32 and
    in f64, the chosen chunk height (32 or 16 rows) and Y tiles (2 or 1)
    fit the 227 KB a block may use; 32 rows and two Y tiles wherever they
    fit."""
    pad = fused_gram._pad
    geos = {q: fused_gram.wide_geometry(q) for q in range(81, 641)}
    for k in range(1, 513):
        for p1 in range(max(1, 81 - k), 641 - pad(k, 128) + 1):
            if pad(k, 128) + pad(p1, 128) > 640:
                break
            geo = geos[k + p1]
            for es in (4, 8):
                assert fused_gram.wide_smem(geo["rows"], geo["ytiles"], k,
                                            p1, es, geo["nbg"]) <= 232_448
    for q, geo in geos.items():
        if (geo["rows"], geo["ytiles"]) != (32, 2):
            assert fused_gram.wide_smem(32, 2, q, 0, 8, geo["nbg"]) > 232_448
    assert fused_gram.wide_geometry(229)["rows"] == 32
    assert fused_gram.wide_geometry(640)["rows"] == 16


@pytest.mark.parametrize("n,k,p1", [(100_000, 60, 169), (100_001, 61, 170),
                                    (1_001, 128, 511)])
def test_wide_copies_aligned_at_odd_widths(n, k, p1):
    """Each chunk's whole-row spans of T (f32 or f64), A and w start on a
    16-byte boundary of their tensors and of the shared stage, at odd row
    widths such as p1 = 169 (a chunk starts at an even row), and only a
    ragged last chunk leaves a tail of < 16 bytes for plain loads."""
    pad = fused_gram._pad
    rows = fused_gram.wide_geometry(k + p1)["rows"]
    for es in (4, 8):
        tb, ab = pad(rows * k * es, 16), pad(rows * p1 * 8, 16)
        assert tb % 16 == 0 and (tb + ab) % 16 == 0
        for r0 in range(0, n, rows):
            nr = min(rows, n - r0)
            for off, nbytes in ((r0 * k * es, nr * k * es),
                                (r0 * p1 * 8, nr * p1 * 8), (r0 * 8, nr * 8)):
                assert off % 16 == 0
                assert nbytes % 16 == 0 or r0 + rows >= n


@pytest.mark.parametrize("k,p1", [(60, 169), (128, 512)])
def test_wide_cuda_wrapper_admits_and_needs_a_card(k, p1):
    """The CUDA wrapper takes the wide shapes (its checks of types,
    shapes and the table pass) and then refuses CPU tensors, counting no
    launch; it raises rather than falling back."""
    T, A, w = (_t(x) for x in gram_inputs(300, k, p1))
    before = fused_gram_joint_cuda.launches
    with pytest.raises(ValueError, match="one card"):
        fused_gram_joint_cuda(T, A, w)
    assert fused_gram_joint_cuda.launches == before


@pytest.mark.parametrize("k,p1,fused", [(60, 169, True), (128, 512, True),
                                        (129, 512, False)])
def test_joint_gram_routes_like_the_reference(monkeypatch, k, p1, fused):
    """With the fused interior active, _joint_gram takes the fused
    dispatcher for every shape the reference's table admits (the binary
    MSP's q = 229 included) and gram32_joint only past it."""
    monkeypatch.setenv("PINT_TPU_TORCH_FUSED_INTERIOR", "force")
    calls = []
    plain = fused_gram.fused_gram_joint

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return plain(*a, **kw)

    monkeypatch.setattr(fused_gram, "fused_gram_joint", counted)
    T, A, w = (_t(x) for x in gram_inputs(200, k, p1))
    out = gls._joint_gram(T, A, w)
    assert [g.shape for g in out] == [(k, k), (k, p1), (p1, p1)]
    assert calls == ([(200, k)] if fused else [])


@pytest.mark.parametrize("n,k,p1", JOINT_CASES)
def test_wide_plain_matches_pallas_interpret(ref, n, k, p1):
    """fused_gram_joint_plain at q = 228, 229 and the widest 640 against
    the reference's Pallas kernel in interpret mode: 3e-6 of scale (the
    narrow cases' bound; both sum 128-row f32 chunks, in f64 here and in
    compensated f32 there)."""
    T, A, w = gram_inputs(n, k, p1)
    got = fused_gram_joint_plain(torch.as_tensor(T, dtype=torch.float32),
                                 _t(A), _t(w))
    for part, g in zip(("tt", "ta", "aa"), got):
        want = ref[f"joint/{n}/{k}/{p1}/{part}"]
        assert g.dtype == F64 and g.shape == want.shape
        scale = np.max(np.abs(want))
        assert np.max(np.abs(g.numpy() - want)) <= 3e-6 * scale, part


@pytest.mark.parametrize("n,k,p", FOURIER_GRAM)
def test_fourier_gram_wide_matches_pallas_interpret(ref, n, k, p):
    """fourier_gram at k = 100 or 30 harmonics and p = 169 columns (past
    the old k <= 64, p <= 16 limits) against the reference's kernel in
    interpret mode: 2e-6 of scale (f32 basis values from f32 phases in
    both; f32 sums there, f64 sums here)."""
    t, f, w, X = fourier_inputs(n, k, p)
    sig, twx = fourier.fourier_gram(_t(t), _t(f), _t(w), _t(X))
    for name, g in (("sig", sig), ("twx", twx)):
        want = ref[f"gram/{n}/{k}/{p}/{name}"]
        assert g.shape == want.shape
        scale = np.max(np.abs(want))
        assert np.max(np.abs(g.numpy() - want)) <= 2e-6 * scale, name


@pytest.mark.parametrize("n,k,m", FOURIER_APPLY)
def test_fourier_apply_wide_matches_pallas_interpret(ref, n, k, m):
    """fourier_apply at k = 100 and m = 40 columns against the
    reference's kernel in interpret mode: 2e-6 of scale."""
    t, f, _, _ = fourier_inputs(n, k, 1)
    z = np.random.default_rng(9).normal(size=(2 * k, m))
    y = fourier.fourier_apply(_t(t), _t(f), _t(z))
    want = ref[f"apply/{n}/{k}/{m}"]
    assert y.shape == want.shape
    assert np.max(np.abs(y.numpy() - want)) <= 2e-6 * np.max(np.abs(want))


def test_column_slices_cover_each_column_once():
    """The CUDA wrappers' slices: contiguous, in order, each at most the
    width; the chunk height and the launch geometry of a slice depend on
    k and the slice alone, so every launch of one call sums its columns
    as one wide launch would."""
    for total, width in ((169, 16), (40, 16), (16, 16), (7, 312), (169, 169)):
        sl = fourier._slices(total, width)
        assert sl[0][0] == 0 and sl[-1][1] == total
        assert all(b - a <= width for a, b in sl)
        assert all(sl[i][1] == sl[i + 1][0] for i in range(len(sl) - 1))
    for k in (1, 30, 64, 100, 200):
        assert fourier.gram_columns(k) >= fourier.GRAM_P_MIN
        assert fourier.fourier_gram_table(10_000, k, 16)[0] == min(
            -(-10_000 // fourier.gram_rows(k)), fourier.NB_MAX)
    assert fourier.gram_rows(64) == 64 and fourier.gram_rows(100) == 32


def test_plain_versions_by_column_slices():
    """The plain versions' columns do not depend on the other columns:
    slices of 16 columns reproduce the wide call (f64 sums of the same
    f32 products; 1e-15 of scale covers the BLAS order)."""
    t, f, w, X = (_t(x) for x in fourier_inputs(700, 100, 40))
    sig, twx = fourier.fourier_gram(t, f, w, X)
    for a, b in fourier._slices(40, 16):
        s2, t2 = fourier.fourier_gram(t, f, w, X[:, a:b].contiguous())
        assert torch.equal(s2, sig)
        assert torch.max(torch.abs(t2 - twx[:, a:b])) <= 1e-15 * torch.max(
            torch.abs(twx))
    z = _t(np.random.default_rng(2).normal(size=(200, 40)))
    y = fourier.fourier_apply(t, f, z)
    for a, b in fourier._slices(40, 16):
        ys = fourier.fourier_apply(t, f, z[:, a:b].contiguous())
        assert torch.equal(ys, y[:, a:b])


def _kernel_vs_plain(kernel, plain, *args):
    got, again, want = kernel(*args), kernel(*args), plain(*args)
    if isinstance(want, torch.Tensor):
        got, again, want = (got,), (again,), (want,)
    for g, g2, ww in zip(got, again, want):
        assert torch.equal(g, g2)
        scale = torch.max(torch.abs(ww))
        assert torch.max(torch.abs(g.double() - ww.double())) <= 3e-6 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("t32", [False, True])
@pytest.mark.parametrize("n,k,p1", [(100_000, 60, 169), (100_000, 60, 168),
                                    (100_000, 128, 512), (100_001, 61, 170)])
def test_wide_fused_gram_kernel_matches_plain_on_card(n, k, p1, t32):
    """csrc/fused_gram_wide.cu against the plain version on the card at
    q = 229, 228, 640 and a ragged n, T in f64 and f32: 3e-6 of scale and
    bitwise on rerun, counted as a wide launch."""
    dev = _card()
    T, A, w = (_t(x, dev) for x in gram_inputs(n, k, p1))
    before = fused_gram_joint_cuda.wide_launches
    _kernel_vs_plain(fused_gram_joint_cuda, fused_gram_joint_plain,
                     T.float() if t32 else T, A, w)
    assert fused_gram_joint_cuda.wide_launches - before == 2


@pytest.mark.gpu
@pytest.mark.parametrize("k,p", [(30, 169), (100, 169), (30, 400)])
def test_fourier_gram_column_slices_on_card(k, p):
    """fourier_gram_cuda at p = 169 (one launch) and 400 (two: past
    gram_columns(30) = 312) against its plain version; and each slice of
    16 columns of X, launched alone, gives the bits of the same columns
    of the call (and the same Sigma): a column's sum does not depend on
    the others, so the wrapper's slicing changes no bit."""
    dev = _card()
    t, f, w, X = (_t(x, dev) for x in fourier_inputs(100_000, k, p))
    before = fourier.fourier_gram_cuda.launches
    _kernel_vs_plain(fourier.fourier_gram_cuda, fourier.fourier_gram_plain,
                     t, f, w, X)
    assert fourier.fourier_gram_cuda.launches - before == 2 * -(
        -p // fourier.gram_columns(k))
    sig, twx = fourier.fourier_gram_cuda(t, f, w, X)
    for a, b in fourier._slices(p, 16):
        s, tw = fourier.fourier_gram_cuda(t, f, w, X[:, a:b].contiguous())
        assert torch.equal(s, sig) and torch.equal(tw, twx[:, a:b])


@pytest.mark.gpu
def test_fourier_apply_wide_on_card():
    """fourier_apply_cuda at k = 100 and m = 40 (three launches) against
    its plain version; its first 16 columns are one launch's bits."""
    dev = _card()
    t, f, _, _ = (_t(x, dev) for x in fourier_inputs(100_000, 100, 1))
    z = _t(np.random.default_rng(9).normal(size=(200, 40)), dev)
    _kernel_vs_plain(fourier.fourier_apply_cuda, fourier.fourier_apply_plain,
                     t, f, z)
    y = fourier.fourier_apply_cuda(t, f, z)
    assert torch.equal(y[:, :16],
                       fourier.fourier_apply_cuda(t, f, z[:, :16].contiguous()))
