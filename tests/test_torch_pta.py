"""Parity of the port's PTA batch with the JAX package.

``parallel/pta.py::PTABatch`` runs one pulsar's compiled model over a
pulsar axis with ``torch.func.vmap``, each pulsar's bundle and reference
values swapped in.  On the three pulsars of the reference's
tests/test_pta_batch.py (64, 48 and 64 TOAs; their states carried across
from the reference), the batched fit equals the individual GLSFitter
fits and the reference's ``PTABatch.fit``; on pulsars of
``simulation.pta_pars`` (the card's composition cut to 4 DMX ranges),
whose F0, DM, PEPOCH, sky position and orbit differ, the batched
residuals and steps equal each pulsar's own.  The joint Gram's pulsar
axis (``ops/fused_gram.py``) is held to P single calls.  Tolerances are
stated per test.
"""

import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from torch_reference import (  # noqa: E402
    gram_inputs,
    load_state,
    run_reference,
)

from pint_tpu_torch.convert import state_from_numpy  # noqa: E402
from pint_tpu_torch.exceptions import PintTpuError  # noqa: E402
from pint_tpu_torch.fitting.base import DegeneracyWarning  # noqa: E402
from pint_tpu_torch.fitting.gls import (  # noqa: E402
    GLSFitter,
    gauss_newton_step,
)
from pint_tpu_torch.models.builder import get_model  # noqa: E402
from pint_tpu_torch.ops import fused_gram  # noqa: E402
from pint_tpu_torch.parallel.pta import (  # noqa: E402
    PAD_ERROR_US,
    PTABatch,
    pad_bundle_to,
)
from pint_tpu_torch.simulation import (  # noqa: E402
    MSP_FREQS,
    make_population,
    make_test_pulsar,
    pta_pars,
)

#: the reference's tests/test_pta_batch.py composition
PAR = """
PSR              {name}
F0               {f0}  1
F1               -5.38e-16          1
PEPOCH           55000
DM               {dm}             1
EFAC             -f L-wide 1.2
TNREDAMP         -13.2
TNREDGAM         3.1
TNREDC           8
"""
PULSARS = [("A", 245.42, 3.14, 64, 1), ("B", 315.87, 12.9, 48, 2),
           ("C", 188.21, 40.1, 64, 3)]

_SCRIPT = textwrap.dedent(f"""
from pint_tpu.parallel.pta import PTABatch
from pint_tpu.simulation import make_test_pulsar

cms = []
for name, f0, dm, n, seed in {PULSARS!r}:
    m, t = make_test_pulsar({PAR!r}.format(name=name, f0=f0, dm=dm),
                            ntoa=n, seed=seed, freqs=(1400.0, 2300.0))
    cm = m.compile(t)
    export_state(cm, name)
    cms.append(cm)
batch = PTABatch(cms)
xs, chi2 = batch.fit(maxiter=3)
OUT["fit/xs"] = np.asarray(xs)
OUT["fit/chi2"] = np.asarray(chi2)
OUT["fit/cov"] = np.asarray(batch.cov)
OUT["res"] = np.asarray(batch.residuals(batch.x0()))
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("pta")
    return run_reference(_SCRIPT, d / "pta.npz", timeout=600)


def _load(ref, name):
    model, bundle, _ = state_from_numpy(load_state(ref, name), device="cpu")
    return model, bundle


@pytest.fixture
def states(ref):
    """Fresh (model, bundle) of the three pulsars (a fit commits)."""
    return [_load(ref, p[0]) for p in PULSARS]


def _batch(states):
    return PTABatch([m.compile(b) for m, b in states])


def _fit_quiet(f, maxiter=3):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DegeneracyWarning)
        return f.fit_toas(maxiter=maxiter)


def test_batch_matches_individual_fits_and_reference(ref, states):
    """The batched f64 fit: each pulsar's chi2 within 1e-8 relative of
    its own GLSFitter fit and of the reference's PTABatch.fit, the
    fitted deltas within 1e-6 of the reference's uncertainties, the
    residuals of the padded batch within 1e-11 s of the reference's."""
    batch = _batch(states)
    assert batch.npulsars == 3 and batch.ntoa == 64
    res = batch.residuals(batch.x0()).numpy()
    np.testing.assert_allclose(res, ref["res"], rtol=0, atol=1e-11)
    xs, chi2 = batch.fit(maxiter=3)
    assert batch.steps_taken == 4
    np.testing.assert_allclose(chi2.numpy(), ref["fit/chi2"], rtol=1e-8)
    sig = np.sqrt(np.diagonal(ref["fit/cov"], axis1=1, axis2=2))
    assert np.all(np.abs(xs.numpy() - ref["fit/xs"]) <= 1e-6 * sig)
    np.testing.assert_allclose(batch.cov, ref["fit/cov"], rtol=1e-6)
    for i, (_, bundle) in enumerate(states):
        model, _ = _load(ref, PULSARS[i][0])
        f = GLSFitter(bundle, model, device="cpu")
        c = _fit_quiet(f)
        assert float(chi2[i]) == pytest.approx(c, rel=1e-8), i


def test_commit_writes_back(states):
    """commit folds each pulsar's deltas and uncertainties into its host
    model."""
    batch = _batch(states)
    xs, _ = batch.fit(maxiter=2)
    batch.commit(xs)
    for (m, _), cm, (_, f0, *_rest) in zip(states, batch.cms, PULSARS):
        assert float(m.params["F0"].value.to_float()) == pytest.approx(
            f0, abs=1e-8)
        assert m.params["F0"].uncertainty > 0
        # the compiled model now anchors x = 0 at the fitted values
        assert np.isclose(cm.ref["DM"], float(m.params["DM"].value))


def test_padded_fit_matches_unpadded(ref):
    """Padding the TOA axis with PAD_ERROR_US TOAs does not move a fit:
    chi2 within 1e-9 relative, every value within 1e-6 of its
    uncertainty (the reference's test_padded_fit_matches_unpadded)."""
    m1, b1 = _load(ref, "B")
    m2, b2 = _load(ref, "B")
    padded = pad_bundle_to(b2, 96)
    assert padded.ntoa == 96
    assert torch.all(padded.error_us[48:] == PAD_ERROR_US)
    assert torch.equal(padded.tdb_day[48:], b2.tdb_day[-1].expand(48))
    f_ref = GLSFitter(b1, m1, device="cpu")
    c_ref = _fit_quiet(f_ref)
    f_pad = GLSFitter(padded, m2, device="cpu")
    c_pad = _fit_quiet(f_pad)
    assert c_pad == pytest.approx(c_ref, rel=1e-9)
    sig = np.sqrt(np.diag(f_ref.parameter_covariance_matrix))
    for i, n in enumerate(f_ref.cm.free_names):
        a, b = m1.params[n].value, m2.params[n].value
        a = float(a.to_float()) if hasattr(a, "to_float") else float(a)
        b = float(b.to_float()) if hasattr(b, "to_float") else float(b)
        assert abs(a - b) <= 1e-6 * sig[i] + 1e-30, n
    with pytest.raises(PintTpuError, match="cannot pad"):
        pad_bundle_to(b1, 10)


def test_mixed_batch_launches_the_gram_once_a_step(states, monkeypatch):
    """'mixed' through the joint Gram's plain version (forced on the CPU,
    as on the card) calls it ONCE per batched step, for all pulsars, and
    lands within the reference's tolerance class of the f64 batch
    (test_pta_batch_mixed_mode_matches_f64): chi2 1e-3 relative, deltas
    within 5e-2 sigma."""
    monkeypatch.setenv("PINT_TPU_TORCH_FUSED_INTERIOR", "force")
    monkeypatch.setenv("PINT_TPU_TORCH_SOLVE_IR", "force")
    batch = _batch(states)
    xs_f, chi2_f = batch.fit(maxiter=3, mode="f64")
    cov_f = batch.cov
    calls = []
    plain = fused_gram.fused_gram_joint_plain

    def counted(T, A, w, precision="highest"):
        calls.append(tuple(T.shape))
        return plain(T, A, w, precision)

    monkeypatch.setattr(fused_gram, "fused_gram_joint_plain", counted)
    xs_m, chi2_m = batch.fit(maxiter=3, mode="mixed")
    assert len(calls) == batch.steps_taken == 4
    assert all(c[0] == 3 and c[1] == 64 for c in calls)
    np.testing.assert_allclose(chi2_m.numpy(), chi2_f.numpy(), rtol=1e-3)
    sig = np.sqrt(np.diagonal(cov_f, axis1=1, axis2=2))
    assert np.all(np.abs((xs_m - xs_f).numpy()) < 5e-2 * sig)


@pytest.fixture(scope="module")
def pta3():
    """Three pulsars of pta_pars' composition at 4 DMX ranges, with their
    own F0, F1, sky positions, DM, PEPOCH/POSEPOCH and orbits, and 40,
    64 and 52 TOAs on the synthetic orbit."""
    out = []
    for par, n, seed in zip(pta_pars(3, ndmx=4, seed=5), (40, 64, 52),
                            (1, 2, 3)):
        out.append(make_test_pulsar(
            par, ntoa=n, start_mjd=53000.0, end_mjd=57500.0, seed=seed,
            iterations=1, orbit=True, orbit_in_phase=True,
            freqs=MSP_FREQS, device="cpu"))
    return out


def test_reference_values_reach_each_pulsar(pta3):
    """Each pulsar's batched residuals equal its own CompiledModel's to
    the bit (its own F0, DM, PEPOCH, orbit and astrometry anchors ride
    the pulsar axis), and its batched f64 step equals its own step
    within 1e-10 of the largest component (the pulsar axis changes no
    operation, only the batching of the reductions)."""
    cms = [m.compile(t, device="cpu") for m, t in pta3]
    def value(v):  # an epoch is (day, HostDD seconds)
        return (float(v[0]) + float(v[1].hi) / 86400.0
                if isinstance(v, tuple) else float(v))

    vals = {n: {value(cm.ref[n]) for cm in cms}
            for n in ("F0", "DM", "PEPOCH", "PB", "A1", "TASC", "ELONG")}
    assert all(len(v) == 3 for v in vals.values()), vals
    batch = PTABatch(cms)
    assert batch.ntoa == 64
    res = batch.residuals(batch.x0())
    xs, chi2, (covn, _) = batch.fit_step(batch.x0(), mode="f64")
    for i, cm in enumerate(cms):
        n = cm.bundle.ntoa
        own = cm.time_residuals(cm.x0(), subtract_mean=False)
        assert torch.equal(res[i, :n], own), i
        # padded rows repeat the last TOA
        assert torch.all(res[i, n:] == own[-1])
        xn, (cn, _), c2, _ = gauss_newton_step(cm, cm.x0(), "f64")
        scale = float(xn.abs().max())
        assert float((xs[i] - xn).abs().max()) <= 1e-10 * scale, i
        assert float(chi2[i]) == pytest.approx(float(c2), rel=1e-10), i


def test_population_batches():
    """make_population's par-text variants share the base's composition
    and its ingested TOAs, their free values moved by ``spread``
    relative: they batch, and each batched residual equals its own
    model's."""
    pars, toas = make_population(PAR.format(name="P", f0=245.42,
                                             dm=3.14), 3, ntoa=32,
                                 spread=1e-9, device="cpu")
    assert all(isinstance(p, str) for p in pars)
    models = [get_model(p) for p in pars]
    f0 = [m.params["F0"].internal() for m in models]
    assert len({float(v.hi) + float(v.lo) for v in f0}) == 3
    assert all(abs(float((v - f0[0]).to_float())) <= 1e-7 * 245.42
               for v in f0)
    cms = [m.compile(toas, device="cpu") for m in models]
    batch = PTABatch(cms)
    res = batch.residuals(batch.x0())
    for i, cm in enumerate(cms):
        assert torch.equal(res[i], cm.time_residuals(
            cm.x0(), subtract_mean=False)), i
    with pytest.raises(ValueError, match="npsr"):
        make_population(PAR.format(name="P", f0=1.0, dm=1.0), 0)


def _par_variant(extra="", drop=()):
    base = PAR.format(name="X", f0=200.0, dm=5.0)
    lines = [ln for ln in base.splitlines()
             if not ln.split() or ln.split()[0] not in drop]
    return "\n".join(lines) + "\n" + extra


def _cm(par, n=32, seed=9):
    m, t = make_test_pulsar(par, ntoa=n, seed=seed, freqs=(1400.0, 2300.0),
                            device="cpu")
    return m.compile(t, device="cpu")


def test_batch_refusals(states):
    """Every refusal of the reference's PTABatch: an empty batch;
    different free parameters; mask keys; mask and noise-basis structure
    (TNREDC); numeric parameter sets; static parameters; fit(maxiter=0)
    and an unknown mode; and the port's own: host-read values that
    differ (a glitch with and without a decay term).  shard names
    ROADMAP A8."""
    cm0 = states[0][0].compile(states[0][1])
    with pytest.raises(PintTpuError, match="empty"):
        PTABatch([])
    cases = [
        (_par_variant(drop=("F1",)), "identical free-parameter"),
        (_par_variant("JUMP -f S-wide 1e-6\n"), "identical mask keys"),
        (_par_variant().replace("TNREDC           8",
                                "TNREDC           16"), "noise-basis"),
        (_par_variant("DMEPOCH 55000\n"), "identical numeric"),
    ]
    for par, match in cases:
        with pytest.raises(PintTpuError, match=match):
            PTABatch([cm0, _cm(par)])
    sky = "ELONG 100.0 1\nELAT 10.0 1\n"
    with pytest.raises(PintTpuError, match="identical static"):
        PTABatch([_cm(_par_variant(sky + "PLANET_SHAPIRO N\n")),
                  _cm(_par_variant(sky + "PLANET_SHAPIRO Y\n"))])
    glitch = "GLEP_1 55000\nGLF0D_1 1e-9\nGLTD_1 {}\n"
    with pytest.raises(PintTpuError, match="host-read"):
        PTABatch([_cm(_par_variant(glitch.format(0))),
                  _cm(_par_variant(glitch.format(10)))])
    batch = PTABatch([cm0])
    with pytest.raises(PintTpuError, match="maxiter"):
        batch.fit(maxiter=0)
    with pytest.raises(PintTpuError, match="unknown PTA fit mode"):
        batch.fit(maxiter=1, mode="fourier")
    with pytest.raises(NotImplementedError, match="A8"):
        batch.shard(None)


@pytest.mark.parametrize("p1", [7, 119])
def test_batched_plain_gram_equals_single_grams(p1):
    """The joint Gram's plain version with a pulsar axis equals P single
    calls, and ``fused_gram_joint`` inside torch.func.vmap (its vmap
    rule: one batched call) equals the explicit batched call, bit for
    bit on the CPU; nested vmaps and a shared basis fold into the same
    one call."""
    ins = [gram_inputs(257, 60, p1, seed=s) for s in range(3)]
    T, A, w = (torch.tensor(np.stack(x)) for x in zip(*ins))
    batched = fused_gram.fused_gram_joint(T, A, w)
    mapped = torch.func.vmap(fused_gram.fused_gram_joint)(T, A, w)
    for i in range(3):
        single = fused_gram.fused_gram_joint_plain(T[i], A[i], w[i])
        for s, b, v in zip(single, batched, mapped):
            assert torch.equal(s, b[i]) and torch.equal(s, v[i])
    nested = torch.func.vmap(torch.func.vmap(fused_gram.fused_gram_joint))(
        T[None].expand(2, -1, -1, -1), A[None].expand(2, -1, -1, -1),
        w[None].expand(2, -1, -1))
    assert all(torch.equal(n[1], b) for n, b in zip(nested, batched))
    shared = torch.func.vmap(fused_gram.fused_gram_joint,
                             in_dims=(None, 0, 0))(T[0], A, w)
    one = fused_gram.fused_gram_joint_plain(T[0], A[1], w[1])
    assert all(torch.equal(s[1], o) for s, o in zip(shared, one))


def test_batched_block_table():
    """A pulsar batch shares the single launch's blocks out over its
    pulsars: NB_MAX / P rounded up (at least one) a pulsar, at most the
    rows' chunks; P = 1 is the single launch."""
    for n, k, p1 in ((100000, 60, 7), (10000, 60, 119), (200000, 60, 170)):
        one = fused_gram.fused_block_table(n, k, p1)
        assert fused_gram.fused_block_table(n, k, p1, 1) == one
        for P in (2, 45, 200):
            nb, q_pad, threads = fused_gram.fused_block_table(n, k, p1, P)
            assert (q_pad, threads) == one[1:]
            # these n give more row chunks than the single launch's blocks
            assert nb == -(-one[0] // P) >= 1
    assert fused_gram.fused_block_table(100, 60, 7, 0) is None
    assert fused_gram.fused_block_table(100, 60, 7, 70000) is None


@pytest.mark.gpu
def test_batched_kernel_on_card_matches_single_launches():
    """On the card one batched launch equals P single launches within
    3e-6 of scale and its plain version likewise, and reruns bitwise, at
    the narrow (q = 67) and the wide (q = 179) path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    for p1 in (7, 119):
        ins = [gram_inputs(2001, 60, p1, seed=s) for s in range(5)]
        T, A, w = (torch.tensor(np.stack(x), device="cuda")
                   for x in zip(*ins))
        before = fused_gram.fused_gram_joint_cuda.batched_launches
        got = fused_gram.fused_gram_joint_cuda(T, A, w)
        again = fused_gram.fused_gram_joint_cuda(T, A, w)
        assert fused_gram.fused_gram_joint_cuda.batched_launches == (
            before + 2)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        plain = fused_gram.fused_gram_joint_plain(T, A, w)
        for i in range(5):
            single = fused_gram.fused_gram_joint_cuda(
                T[i].clone(), A[i].clone(), w[i].clone())
            for s, g, p in zip(single, got, plain):
                scale = float(p[i].abs().max())
                assert float((g[i] - p[i]).abs().max()) <= 3e-6 * scale
                assert float((g[i] - s).abs().max()) <= 3e-6 * scale
