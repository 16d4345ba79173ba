"""Session cache: composition sessions and their batched step programs.

Counterpart of ``pint_tpu/serve/session.py``.  Serving state is split
into two independently LRU'd layers, so that a million distinct par files
cost a million *lightweight host records* but only one compiled session
per model *composition*:

- a :class:`ParRecord` is everything that is truly per-par — the parsed
  TimingModel, its reference values as two host vectors (what the
  batcher stacks per flush), and a small polyco cache for phase
  prediction.  Building one is a host-side parse, never a program build.
- a :class:`Session` is keyed by **(composition key, shape bucket)**
  (with the step mode, fixed per device per composition, recorded for
  observability): the prototype CompiledModel every par of the
  composition runs through.  Per-par state (bundle columns, reference
  values, delta vectors) rides each dispatch as inputs of the step
  program, stacked on the leading pulsar axis, so N distinct-par clients
  of one composition cost exactly one program build (on the card, one
  capture) per (bucket, batch capacity) and replica.

The :func:`composition_key` is ``parallel/pta.py::PTABatch``'s
compatibility contract precomputed.  Beyond the reference's key it folds
in each component's ``host_state()`` (values its kernels read on the host
when a program is built, which a batch cannot vary row by row) and the
pulse-tracking mode; pars that differ in them get sessions of their own
instead of failing a stacked batch.

The step programs (:func:`build_residuals_kernel`,
:func:`build_fit_kernel`) take the stacked operands as inputs:
``torch.func.vmap`` runs a private copy of the session's prototype over
the pulsar axis with each row's bundle and references swapped in (the
serving sibling of ``PTABatch._vmapped``), behind the replica's program
cache (``runtime/graphs.py::ProgramCache``: guarded, traced, captured
once on the card).  A fit is ``maxiter`` calls of one batched step
program whose carry ``(x, chi2_prev, cov, done, conv)`` stays on the
device, masked row by row with ``torch.where``: the reference's vmapped
``lax.scan`` (``pint_tpu/fitting/base.py::make_scan_fit_loop``), a
converged row frozen, a non-finite chi2 freezing its row, and no host
read until the fence.  In ``'mixed'`` mode each call launches the joint
Gram kernel once for the whole batch (``ops/fused_gram.py``'s vmap rule).
"""

from __future__ import annotations

import contextlib
import copy
import os
import threading
from collections import OrderedDict

import numpy as np
import torch
from torch.func import vmap

from pint_tpu_torch import obs as _obs
from pint_tpu_torch.device import F64
from pint_tpu_torch.exceptions import PintTpuError
from pint_tpu_torch.fitting.base import noffset
from pint_tpu_torch.fitting.gls import default_accel_mode, gauss_newton_step
from pint_tpu_torch.models.parameter import MJDParameter
from pint_tpu_torch.models.timing_model import CompiledModel, reference_values
from pint_tpu_torch.obs.trace import TRACER
from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.parallel.pta import pad_bundle_to
from pint_tpu_torch.runtime import lockwitness
from pint_tpu_torch.runtime.graphs import device_lock, flatten
from pint_tpu_torch.serve.batcher import tree_map
from pint_tpu_torch.timebase.hostdd import HostDD
from pint_tpu_torch.toas.bundle import TOABundle, as_table, make_bundle
from pint_tpu_torch.utils import compute_hash


def shape_bucket(n: int, min_bucket: int | None = None) -> int:
    """TOA-axis bucket: the next power of two >= max(n, min_bucket).

    Power-of-two buckets bound the program surface to log2(n_max)
    distinct shapes while wasting at most 2x padding (padded TOAs are
    statistically invisible — parallel/pta.py::PAD_ERROR_US).
    ``$PINT_TPU_SERVE_MIN_BUCKET`` (default 64) floors the bucket so tiny
    requests coalesce instead of fragmenting the program cache."""
    if min_bucket is None:
        min_bucket = int(
            os.environ.get("PINT_TPU_SERVE_MIN_BUCKET", "64")
        )
    if n < 1:
        raise PintTpuError(f"cannot bucket {n} TOAs")
    b = max(int(min_bucket), 1)
    while b < n:
        b <<= 1
    return b


def par_text(par) -> str:
    """Canonical par-file text of a request's ``par`` field."""
    return par if isinstance(par, str) else par.as_parfile()


def par_content_hash(par) -> str:
    return compute_hash(par_text(par))[:16]


# -- a request's TOAs on the host ----------------------------------------
def request_table(toas, model) -> dict:
    """The host TOA table of a request's ``toas``: a port ``TOAs`` is
    ingested with the model's options when it is not yet (the reference's
    ``ingest_for_model`` on admission), a table is taken as it is."""
    from pint_tpu_torch.toas.ingest import ingest_for_model
    from pint_tpu_torch.toas.toas import TOAs

    if isinstance(toas, TOAs) and toas.t_tdb is None:
        ingest_for_model(toas, model)
    return as_table(toas)


def _sorted_dicts(bundle: TOABundle) -> TOABundle:
    """The bundle with its mask and planet columns in key order, so that
    every request of a composition flattens to the same leaf order."""
    return bundle._replace(
        masks={k: bundle.masks[k] for k in sorted(bundle.masks)},
        obs_planet_pos_ls={k: bundle.obs_planet_pos_ls[k]
                           for k in sorted(bundle.obs_planet_pos_ls)},
    )


def request_bundles(model, table):
    """(CPU-tensor bundle, host-numpy bundle) of one request's table with
    the model's masks: the first keys the composition, the second is the
    request's stacked operand (the numpy arrays share the tensors'
    memory)."""
    cpu = _sorted_dicts(make_bundle(table, model._build_masks(table),
                                    torch.device("cpu")))
    host = tree_map(lambda t: t.numpy(), cpu)
    return cpu, host


# -- reference values as host vectors -----------------------------------
def ref_parts(model, free_names):
    """A model's reference values as the batcher stacks them:
    ``(refvec, flatvec, static, layout)``.

    ``refvec`` holds every numeric reference value and component anchor
    (``timing_model.py::split_ref`` / ``device_anchors``), in ``layout``
    order — the names sorted, a DD value two entries, an epoch three;
    ``flatvec`` the plain-float references of the free parameters (the
    prototype's ``_flat_ref``); ``static`` the values a program takes as
    Python values (bools, strings, pair parameters)."""
    ref = reference_values(model)
    num, static = {}, {}
    for n, v in ref.items():
        if isinstance(v, HostDD):
            num[n] = ("dd", [v.hi, v.lo])
        elif isinstance(v, tuple) and len(v) == 2 and isinstance(
                v[1], HostDD):
            num[n] = ("epoch", [v[0], v[1].hi, v[1].lo])
        elif isinstance(v, (float, int)) and not isinstance(v, bool):
            num[n] = ("f", [v])
        else:
            static[n] = v
    anchors = {}
    for c in model._ordered_components():
        anchors.update(c.anchors())
    layout, vals = [], []
    for n in sorted(num):
        kind, vs = num[n]
        layout.append(("ref", n, kind))
        vals += vs
    for k in sorted(anchors):
        layout.append(("anchor", k, len(anchors[k])))
        vals += list(anchors[k])
    refvec = np.array([float(v) for v in vals], dtype=np.float64)
    flat_names = [n for n in free_names
                  if not isinstance(ref[n], (HostDD, tuple))]
    flatvec = np.array([float(ref[n]) for n in flat_names],
                       dtype=np.float64)
    return refvec, flatvec, static, tuple(layout)


def rebuild_refs(layout, row) -> dict:
    """The prototype's device reference dict (numeric values and
    anchors) from one row of stacked ``refvec``s, by ``layout``."""
    vals = row.unbind(0)
    out = {}
    i = 0
    for tag, name, kind in layout:
        if kind == "f":
            out[name] = vals[i]
            i += 1
        elif kind == "dd":
            out[name] = DD(vals[i], vals[i + 1])
            i += 2
        elif kind == "epoch":
            out[name] = (vals[i], DD(vals[i + 1], vals[i + 2]))
            i += 3
        else:  # an anchor of ``kind`` values
            out[name] = tuple(vals[i:i + kind])
            i += kind
    return out


#: process-wide cache of noise-basis structures, keyed by everything that
#: can shape a basis (see _basis_struct): evaluating the basis on the
#: host is the costly part of admitting a cold par of a known structure
_BASIS_STRUCT_CACHE: dict = {}


def _basis_struct(cm) -> tuple:
    """(T.shape[1:], phi.shape) of the model's stacked noise basis, from
    one host evaluation with a structure-keyed cache.  Basis shapes can
    only depend on host-visible structure: the noise component stack and
    its host parameter values (TNREDC), the precomputed basis/mask column
    structure riding in bundle.masks, and the wideband flag."""
    key = (
        tuple(
            (
                type(c).__name__,
                tuple(sorted(
                    (n, repr(p.value)) for n, p in c.params.items()
                )),
            )
            for c in cm.model.noise_components
        ),
        tuple(sorted(
            (k, tuple(v.shape[1:])) for k, v in cm.bundle.masks.items()
        )),
        cm.bundle.dm_meas is not None,
        cm.nfree,
    )
    hit = _BASIS_STRUCT_CACHE.get(key)
    if hit is None:
        T, phi = cm.noise_basis_or_empty(cm.x0())
        hit = _BASIS_STRUCT_CACHE[key] = (
            tuple(T.shape[1:]), tuple(phi.shape)
        )
    return hit


def composition_key(cm, layout, static_ref, phash: str,
                    has_tzr: bool) -> tuple:
    """Hashable structural fingerprint deciding which pars' requests may
    stack on the pulsar axis (the PTABatch compatibility rules,
    precomputed): identical component stacks, free-parameter layouts,
    mask/noise-basis column structure, static references, reference
    layout, components' host state and pulse-tracking mode.  Every field
    is TOA-count independent (``shape[1:]`` throughout), so one key
    covers every bucket.  Models carrying a TZR anchor fold the par hash
    in — the TZR row is the prototype's, so such sessions only batch
    with themselves."""
    key = (
        tuple(type(c).__name__ for c in cm.model._ordered_components()),
        tuple(cm.free_names),
        cm.track_mode,
        bool(cm.subtract_mean),
        tuple(sorted(
            (k, tuple(v.shape[1:])) for k, v in cm.bundle.masks.items()
        )),
        tuple(sorted((k, repr(v)) for k, v in static_ref.items())),
        tuple(layout),
        _basis_struct(cm),
        cm.bundle.dm_meas is not None,
        tuple(sorted(cm.bundle.obs_planet_pos_ls)),
        tuple((n, repr(c.host_state()))
              for n, c in cm.model.components.items()),
    )
    if has_tzr:
        key += (("tzr", phash),)
    return key


def composition_id(composition: tuple) -> str:
    """Short stable label of a composition key for metric names and
    trace attributes (serve.composition.<cid>.*)."""
    return compute_hash(repr(composition))[:8]


class ParRecord:
    """Lightweight per-par serving state: parsed model + reference
    vectors + polyco cache.  A record is pure host state — building one
    never builds a program — and it is what a request contributes to a
    stacked dispatch: its padded bundle plus this record's reference
    vectors, both inputs of the composition session's programs."""

    __slots__ = ("par", "par_hash", "model", "_refs", "_compositions",
                 "_joined", "_polycos")

    def __init__(self, text: str, phash: str):
        from pint_tpu_torch.models.builder import get_model

        self.par = text
        self.par_hash = phash
        self.model = get_model(text)
        self._refs = None  # lazily split (refvec, flatvec, static, layout)
        self._compositions: dict = {}  # (pulse#, wideband, masks) -> key
        self._joined: set = set()  # composition ids already counted
        self._polycos: OrderedDict = OrderedDict()  # span -> Polycos

    # -- runtime references ------------------------------------------------
    def _split_refs(self):
        if self._refs is None:
            self._refs = ref_parts(self.model, self.model.free_params)
        return self._refs

    @property
    def refnum(self):
        """(refvec, flatvec): the host reference vectors stacked per
        flush."""
        refvec, flatvec, _, _ = self._split_refs()
        return refvec, flatvec

    @property
    def static_ref(self) -> dict:
        return self._split_refs()[2]

    @property
    def layout(self) -> tuple:
        return self._split_refs()[3]

    # -- composition membership -------------------------------------------
    def composition_for(self, cpu_bundle) -> tuple:
        """This par's composition key for a request's TOA structure —
        computed from a light CompiledModel over the request's own
        (unpadded) bundle on the host: structure only, no prototype, no
        padding, no TZR ingest (the TZR axis enters the key via the
        model's anchor).  Cached per the TOA structure that can move the
        key: the pulse-number and wideband flags and the mask columns'
        shapes (an ECORR quantization matrix has one column an epoch, so
        two TOA sets of one par may key two compositions, whose programs
        take differently shaped inputs)."""
        flags = (
            not bool(torch.all(torch.isnan(cpu_bundle.pulse_number))),
            cpu_bundle.dm_meas is not None,
            tuple(sorted((k, tuple(v.shape[1:]))
                         for k, v in cpu_bundle.masks.items())),
        )
        comp = self._compositions.get(flags)
        if comp is None:
            cm_light = CompiledModel(self.model, cpu_bundle)
            comp = composition_key(
                cm_light, self.layout, self.static_ref, self.par_hash,
                self.model.tzr_anchor is not None,
            )
            self._compositions[flags] = comp
        return comp

    # -- phase prediction (host-evaluated polycos) ------------------------
    _POLYCO_CACHE = 8  # spans kept per par record

    def polycos_for(self, req):
        """Polycos covering the request's epochs, cached per (obs, freq,
        segmentation, span) — generation evaluates the model once per
        span, on the host CPU; evaluation afterwards is host numpy.
        Returns (polycos, cached)."""
        from pint_tpu_torch.polycos import Polycos

        mjds = np.atleast_1d(np.asarray(req.mjds, dtype=np.float64))
        span_days = req.segment_minutes / 1440.0
        # segment-aligned span so nearby requests share one generation
        start = np.floor(mjds.min() / span_days) * span_days
        end = mjds.max() + 1e-9
        key = (
            req.obs, float(req.obsfreq_mhz),
            float(req.segment_minutes), int(req.ncoeff),
            round(float(start), 9),
            int(np.ceil((end - start) / span_days)),
        )
        cached = key in self._polycos
        if cached:
            self._polycos.move_to_end(key)
            _obs.metrics.counter("serve.polyco.hits").inc()
        else:
            _obs.metrics.counter("serve.polyco.misses").inc()
            with TRACER.span(
                "serve:polyco-generate", "serve", obs=req.obs,
                nseg=key[-1],
            ):
                self._polycos[key] = Polycos.generate(
                    self.model, float(start), float(end),
                    obs=req.obs,
                    segment_minutes=req.segment_minutes,
                    ncoeff=req.ncoeff,
                    obsfreq_mhz=req.obsfreq_mhz,
                    device="cpu",
                )
            while len(self._polycos) > self._POLYCO_CACHE:
                self._polycos.popitem(last=False)
        return self._polycos[key], cached

    # -- fitted-model materialization -------------------------------------
    def commit_clone(self, names, deltas, uncertainties):
        """Fitted deltas folded into a FRESH CLONE of this record's
        already-parsed model (the shared model is never mutated), so the
        host parse happens once per par admission and the
        ``model.parses`` counter stays flat under steady fit traffic.
        ``names`` is the serving session's free-name order (equal to this
        model's by composition).  Mirrors ``CompiledModel.commit``."""
        m = self.model.clone()
        for n, dx, u in zip(
            names, np.asarray(deltas), np.asarray(uncertainties),
        ):
            p = m.params[n]
            ref = p.internal()
            if isinstance(p, MJDParameter):
                p.add_internal_delta(float(dx))
            elif isinstance(ref, HostDD):
                p.set_internal(ref + float(dx))
            else:
                p.set_internal(float(ref) + float(dx))
            p.set_internal_uncertainty(float(u))
        return m


class Session:
    """One (composition, shape bucket) serving session — the prototype
    every par of the composition dispatches through, on the engine's
    device.  The founding par's CompiledModel is scaffolding only:
    request data and per-par references always ride as program inputs,
    so a brand-new par of a known composition serves with no build."""

    def __init__(self, record: ParRecord, table, bucket: int,
                 composition: tuple, device):
        self.bucket = bucket
        self.composition = composition
        self.cid = composition_id(composition)
        self.device = torch.device(device)
        self.founder_hash = record.par_hash
        # the founder's par TEXT rides into the warm-restart ledger
        # (serve/warm_ledger.py): the replay re-parses it, so the
        # composition key recomputes identically at boot
        self.founder_par = record.par
        # the device work of a build is taken in turns with captures on
        # the same device (runtime/graphs.py::device_lock)
        with device_lock(self.device):
            cm = record.model.compile(table, device=self.device)
            if cm.bundle.ntoa > bucket:
                raise PintTpuError(
                    f"{cm.bundle.ntoa} TOAs exceed session bucket {bucket}"
                )
            cm.bundle = pad_bundle_to(cm.bundle, bucket)
            cm._build_refs()  # the flat-reference layout the programs use
        self.cm = cm
        self.mode = default_accel_mode(cm)
        self.static_ref = record.static_ref
        self.layout = record.layout
        # serializes the first call (build, warm-up, capture) of a
        # program of this session across replicas, as the reference
        # serializes its traces
        self.trace_lock = lockwitness.wrap(
            threading.Lock(), "Session.trace_lock"
        )

    @classmethod
    def from_prototype(cls, record: ParRecord, cm, bucket: int,
                       composition: tuple) -> "Session":
        """Rebuild a serving session from a persisted prototype — the
        warm-restart ledger's replay (serve/warm_ledger.py).  ``cm`` is a
        CompiledModel over the ledger sidecar's already padded founder
        bundle (TZR row included), so the boot needs no TOA table, no
        ingest environment and no TZR ingest; the session is identical in
        every shape and dtype to the one live traffic would build."""
        s = object.__new__(cls)
        s.bucket = int(bucket)
        s.composition = composition
        s.cid = composition_id(composition)
        s.device = cm.device
        s.founder_hash = record.par_hash
        s.founder_par = record.par
        if cm.bundle.ntoa != s.bucket:
            raise PintTpuError(
                f"prototype bundle has {cm.bundle.ntoa} TOAs, session "
                f"bucket is {s.bucket}"
            )
        with device_lock(s.device):
            cm._build_refs()
        s.cm = cm
        s.mode = default_accel_mode(cm)
        s.static_ref = record.static_ref
        s.layout = record.layout
        s.trace_lock = lockwitness.wrap(
            threading.Lock(), "Session.trace_lock"
        )
        return s


# -- the batched programs --------------------------------------------------
#: held while a program's Python body runs (every call on the CPU, the
#: build and capture on the card): torch's forward-mode AD levels, which
#: the design matrix's ``jacfwd`` opens, are process-wide, and two threads
#: inside them at once corrupt each other's levels
TRANSFORM_LOCK = threading.Lock()

def operand_structure(ops):
    """(number of leaves, rebuild(leaves) -> tree) of a batch's stacked
    operands (``(bundle stack, (refvecs, flatvecs), xs)``), for programs
    that take the leaves positionally."""
    leaves, rebuild = flatten(tree_map(lambda a: torch.empty(0), ops))
    return len(leaves), rebuild


def _swapped(session: Session, fn):
    """``fn(proto, *args)`` with one row's bundle and references swapped
    into a private copy of the session's prototype (what its kernels
    read off the instance); under vmap the swap installs batched
    tensors.  The copy is the program's own, so concurrent programs of
    one session never see each other's rows."""
    proto = copy.copy(session.cm)
    tzr = session.cm.bundle.tzr
    static, layout = session.static_ref, session.layout

    def call(bundle, refvec, flatvec, *args):
        proto.bundle = bundle._replace(tzr=tzr)
        proto._ref_dev = {**static, **rebuild_refs(layout, refvec)}
        proto._flat_ref = flatvec
        return fn(proto, *args)

    # what a body builds ahead of its first call (host tables) is built
    # on this copy
    call.proto = proto
    return call


def _residuals_run(session: Session, subtract_mean: bool, rebuild):
    """Raw batched residuals body: (bundle stack, (refvecs, flatvecs),
    xs (B, p)) leaves -> (residuals (B, bucket), chi2 (B,))."""
    call = _swapped(
        session,
        lambda cm, x: (
            cm.time_residuals(x, subtract_mean=subtract_mean),
            cm.chi2(x),
        ),
    )

    def run(*leaves):
        bundles, (refvecs, flatvecs), xs = rebuild(leaves)
        flat, brebuild = flatten(bundles)

        def one(x, refvec, flatvec, *bl):
            return call(brebuild(bl), refvec, flatvec, x)

        return vmap(one)(xs, refvecs, flatvecs, *flat)

    return run


def _fit_step_run(session: Session, mode: str, tol_chi2: float, nops,
                  rebuild):
    """Raw batched fit step with the reference scan's carry: (operand
    leaves, x, chi2_prev, covn, norm, done, conv) -> (x, chi2, covn,
    norm, done, conv, nbad, bad), each row masked as
    ``make_scan_fit_loop``'s body masks it."""

    def masked(cm, x, chi2_prev, covn, norm, done, conv):
        x_new, (covn_n, norm_n), chi2, nbad = gauss_newton_step(cm, x, mode)
        bad = ~torch.isfinite(chi2)
        hold = done | bad
        one = torch.ones_like(chi2)
        converged = torch.abs(chi2_prev - chi2) < tol_chi2 * torch.maximum(
            chi2, one)
        return (
            torch.where(hold, x, x_new),
            torch.where(hold, chi2_prev, chi2),
            torch.where(hold, covn, covn_n),
            torch.where(hold, norm, norm_n),
            done | bad | converged,
            conv | (converged & ~done),
            # a done row ran the reference's dead step: nbad 0, not bad
            torch.where(done, torch.zeros_like(nbad), nbad).to(torch.int32),
            bad & ~done,
        )

    call = _swapped(session, masked)

    def run(*leaves):
        bundles, (refvecs, flatvecs), _ = rebuild(leaves[:nops])
        flat, brebuild = flatten(bundles)

        def one(refvec, flatvec, x, chi2p, covn, norm, done, conv, *bl):
            return call(brebuild(bl), refvec, flatvec, x, chi2p, covn,
                        norm, done, conv)

        return vmap(one)(refvecs, flatvecs, *leaves[nops:], *flat)

    return run


class FitKernel:
    """A batched fit as ``maxiter`` calls of one step program, the carry
    on the device between them: -> ``(x, chi2, (covn, norm), conv, nbads
    (B, maxiter), bads (B, maxiter))``, the reference's batched scan
    result."""

    def __init__(self, step, p: int, maxiter: int, device):
        self.step = step
        self.p = p
        self.maxiter = maxiter
        self.device = torch.device(device)

    def __call__(self, *ops):
        xs = ops[-1]
        B, p, dev = xs.shape[0], self.p, self.device
        x = xs
        chi2 = torch.full((B,), float("inf"), dtype=F64, device=dev)
        covn = torch.zeros((B, p, p), dtype=F64, device=dev)
        norm = torch.ones((B, p), dtype=F64, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        conv = torch.zeros((B,), dtype=torch.bool, device=dev)
        nbads, bads = [], []
        for _ in range(self.maxiter):
            x, chi2, covn, norm, done, conv, nb, bd = self.step(
                *ops, x, chi2, covn, norm, done, conv)
            nbads.append(nb)
            bads.append(bd)
        return (x, chi2, (covn, norm), conv, torch.stack(nbads, dim=1),
                torch.stack(bads, dim=1))


def stream_fast_path(cm):
    """Which O(append) incremental path a composition is eligible for:
    ``'fourier'`` (exactly one pure-Fourier achromatic correlated basis —
    appended basis rows evaluate at the stream's FROZEN (freqs, day0)
    anchor, ``models/noise.py::fourier_basis_rows``), ``'white'`` (no
    correlated errors — the ``noise_basis_or_empty`` dummy column, whose
    appended rows are exact zeros), or ``None`` (quantized or chromatic
    bases, whose appended rows are not a function of the new TOAs alone:
    every append of such a composition takes the warm refit rung).
    Answered from the components' structure, the condition under which
    ``CompiledModel.noise_fourier_spec`` returns a spec: no device
    work."""
    if not cm.has_correlated_errors:
        return "white"
    comps = cm.model.noise_components
    specs = [c for c in comps if hasattr(c, "fourier_spec")]
    ncorr = sum(c.introduces_correlated_errors for c in comps)
    return "fourier" if len(specs) == 1 and ncorr == 1 else None


def _masked_ninv(cm, x, bucket, nlive):
    """Per-row inverse white variance with EXACT zeros past ``nlive``:
    pad rows add nothing to the accumulated Gram blocks."""
    live = torch.arange(bucket, device=cm.device) < nlive
    w = 1.0 / torch.square(cm.scaled_sigma(x))
    return torch.where(live, w, torch.zeros_like(w))


def _append_run(session: Session, rebuild):
    """Raw batched O(append) body: (tail bundle stack, (refvecs,
    flatvecs), aux stack) leaves -> (state' stack, dx, covn, norm, chi2).

    Each row's ``aux`` carries a stream's solver state
    (``fitting/gls.py::stream_state_*``), the frozen Fourier anchor
    ``(freqs, day0)`` and the live tail count ``nlive`` as inputs, so
    appending to any stream of the composition replays one program.  A
    failed drift check rolls the row's state back to its PRE-append
    input (``stream_state_solve``'s own fallback is the post-append
    state, which a degenerate update may already have poisoned) and
    gives that row NaN dx and chi2: the signal the stream's fallback
    chain keys on."""
    from pint_tpu_torch.fitting.base import design_with_offset
    from pint_tpu_torch.fitting.gls import (
        stream_state_append,
        stream_state_solve,
    )
    from pint_tpu_torch.models.noise import fourier_basis_rows
    from pint_tpu_torch.ops import solve_policy

    proto = session.cm
    no = noffset(proto)
    bucket = session.bucket
    rtol = solve_policy.stream_drift_rtol()
    path = stream_fast_path(proto)
    if path is None:
        raise PintTpuError(
            "composition has no incremental streaming path "
            "(quantized/chromatic correlated basis) — appends must take "
            "the warm refit rung"
        )
    (kcols,), _ = _basis_struct(proto)

    def one(cm, aux):
        state = aux["state"]
        x = state["x"]
        r = cm.time_residuals(x, subtract_mean=False)
        M = design_with_offset(cm, x)
        Ninv = _masked_ninv(cm, x, bucket, aux["nlive"])
        if path == "fourier":
            T = fourier_basis_rows(cm.bundle, aux["freqs"], aux["day0"])
        else:  # white: the dummy basis column stays exactly zero
            T = torch.zeros((bucket, kcols), dtype=F64, device=cm.device)
        st = stream_state_append(state, r, M, Ninv, T)
        st2, dx, (covn, nrm), chi2 = stream_state_solve(
            st, no, check_rtol=rtol)
        ok = torch.isfinite(chi2) & torch.all(torch.isfinite(dx))
        st2 = {k: torch.where(ok, v, state[k]) for k, v in st2.items()}
        return st2, dx, covn, nrm, chi2

    call = _swapped(session, one)

    def run(*leaves):
        bundles, (refvecs, flatvecs), auxs = rebuild(leaves)
        flat, brebuild = flatten(bundles)
        aflat, arebuild = flatten(auxs)
        na = len(aflat)

        def row(refvec, flatvec, *rest):
            return call(brebuild(rest[na:]), refvec, flatvec,
                        arebuild(rest[:na]))

        return vmap(row)(refvecs, flatvecs, *aflat, *flat)

    return run


def _stream_init_run(session: Session, rebuild):
    """Raw streaming-state (re)build body: (padded full bundle leaves,
    refvec, flatvec, x, nlive) -> the state dict — the only O(n) solver
    work of a stream, run at its open and at every refresh."""
    from pint_tpu_torch.fitting.base import design_with_offset
    from pint_tpu_torch.fitting.gls import stream_state_init

    bucket = session.bucket

    def one(cm, x, nlive):
        r = cm.time_residuals(x, subtract_mean=False)
        M = design_with_offset(cm, x)
        Ninv = _masked_ninv(cm, x, bucket, nlive)
        T, phi = cm.noise_basis_or_empty(x)
        return stream_state_init(r, M, Ninv, T, phi, x)

    call = _swapped(session, one)

    def run(*leaves):
        bundle, refvec, flatvec, x, nlive = rebuild(leaves)
        return call(bundle, refvec, flatvec, x, nlive)

    return run


def _run_for_key(session: Session, key: tuple, ops):
    """The raw batched body (a function of the operand leaves) for one
    fabric group key: the function the key's program would run, for the
    cross-key fuser to compose.  A fit's body is its whole ``maxiter``
    loop (:class:`FitKernel` over the raw step)."""
    nops, rebuild = operand_structure(ops)
    if key[0] == "fit":
        _, _, _, mode, maxiter, tol = key
        step = _fit_step_run(session, mode, tol, nops, rebuild)
        p = session.cm.nfree + noffset(session.cm)
        return FitKernel(step, p, maxiter, session.device)
    if key[0] == "append":
        return _append_run(session, rebuild)
    return _residuals_run(session, key[3], rebuild)


def serialized(inner, lock, replays: bool):
    """``inner`` (a program) called under the serving locks: the first
    call builds, warms up and (on the card) captures, one at a time per
    session (``lock``, the session's ``trace_lock``), as the reference
    serializes its traces; a call that runs the Python body (the first,
    or any on the CPU) holds :data:`TRANSFORM_LOCK`.  ``lock`` may be a
    list of locks, taken in its order."""
    locks = lock if isinstance(lock, list) else [lock]
    first = [True]

    def k(*args):
        if first[0]:
            with contextlib.ExitStack() as stack:
                for lk in locks:
                    stack.enter_context(lk)
                stack.enter_context(TRANSFORM_LOCK)
                first[0] = False
                return inner(*args)
        if replays:
            return inner(*args)
        with TRANSFORM_LOCK:
            return inner(*args)

    return k


def run_fenced(call, device, stream=None):
    """``call()`` launched on ``device`` and read back as host-owned
    numpy: the device's lock is held while it launches and while it is
    read, never across the wait between (which keeps the call's watchdog
    deadlines and its done event through ``capture_gate``), so a capture
    in another thread is never held up by this one's device time.  On the
    CPU a plain call."""
    from pint_tpu_torch.runtime import guard
    from pint_tpu_torch.runtime.graphs import capture_gate

    device = torch.device(device)
    if device.type != "cuda":
        return guard.fence_owned(call())
    ctx = (torch.cuda.stream(stream) if stream is not None
           else contextlib.nullcontext())
    done = torch.cuda.Event()
    with device_lock(device), ctx:
        try:
            out = call()
        except BaseException:
            guard.take_deadlines()  # a partial launch's: dropped
            raise
        deadlines = guard.take_deadlines()
        done.record()
    guard.wait_deadlines(deadlines, capture_gate(device), done)
    with device_lock(device), ctx:
        return guard.fence_owned(out)


def build_residuals_kernel(session: Session, subtract_mean: bool, ops,
                           programs, key, site: str):
    """Batched residuals kernel (see :func:`_residuals_run`): the
    program of ``programs`` (a replica's ProgramCache) under ``key`` —
    guarded, counted (``compile.traces``), on the card captured once and
    replayed."""
    _, rebuild = operand_structure(ops)
    return programs.program(_residuals_run(session, subtract_mean, rebuild),
                            key, site=site)


def build_fit_kernel(session: Session, mode: str, maxiter: int,
                     tol_chi2: float, ops, programs, key, site: str):
    """Batched fit kernel (see :class:`FitKernel`): ``maxiter`` calls of
    one step program of ``programs`` under ``key``."""
    run = _fit_step_run(session, mode, tol_chi2, *operand_structure(ops))
    step = programs.program(run, key, site=site)
    p = session.cm.nfree + noffset(session.cm)
    return FitKernel(step, p, maxiter, session.device)


def build_append_kernel(session: Session, ops, programs, key, site: str):
    """Batched O(append) kernel (see :func:`_append_run`): the program of
    ``programs`` under ``key``.  The stacked solver states are per-batch
    copies of the host-held stream states, which commit only from fenced
    outputs; the warm ledger never records append programs (a replay
    cannot make up a solver-state stack)."""
    _, rebuild = operand_structure(ops)
    return programs.program(_append_run(session, rebuild), key, site=site)


def stream_init_operands(session: Session, host_bundle, refnum, x,
                         nlive: int):
    """The init program's operands: (padded host bundle, refvec,
    flatvec, x, nlive) as host numpy."""
    from pint_tpu_torch.serve.batcher import pad_bundle_np

    refvec, flatvec = refnum
    return (pad_bundle_np(host_bundle, session.bucket), refvec, flatvec,
            np.asarray(x, dtype=np.float64), np.int64(nlive))


def build_stream_init_kernel(session: Session, ops, programs, key,
                             site: str):
    """Streaming-state (re)build kernel (see :func:`_stream_init_run`),
    run directly by the stream at its open and refresh, outside the
    batcher; ``ops`` from :func:`stream_init_operands`."""
    _, rebuild = operand_structure(ops)
    return programs.program(_stream_init_run(session, rebuild), key,
                            site=site)


def build_fused_kernel(parts, programs, combo, site: str):
    """Cross-key fused kernel: ``parts`` is a list of (session, group
    key, operand tree) members, each contributing the body its own
    program runs (:func:`_run_for_key`).  The fused program takes the
    members' operand leaves FLAT, in ``parts`` order, and runs the member
    bodies one after another as ONE program (on the card one captured
    graph, one replay), returning the tuple of per-member outputs.  Each
    member runs the same operations on the same inputs as its solo
    program, so the de-multiplexed results are bitwise those of separate
    dispatches.  Cached under ``combo`` (the sorted member (key,
    capacity) identities) in the replica's program cache."""
    runs, counts = [], []
    for session, key, ops in parts:
        runs.append(_run_for_key(session, key, ops))
        counts.append(operand_structure(ops)[0])

    def fused(*flat):
        out, i = [], 0
        for run, n in zip(runs, counts):
            out.append(run(*flat[i:i + n]))
            i += n
        return tuple(out)

    return programs.program(fused, combo, site=site)


class SessionCache:
    """Thread-safe two-level LRU of serving state.

    Par records (``$PINT_TPU_SERVE_PARS``, default 1024) and composition
    sessions (``$PINT_TPU_SERVE_SESSIONS``, default 32) evict
    INDEPENDENTLY: a population of distinct pars churning through the
    record LRU never drops a session (re-admitting an evicted par is a
    host parse).  ``device`` is where sessions' prototypes live (None:
    the CUDA card)."""

    def __init__(self, max_sessions: int | None = None,
                 max_pars: int | None = None, device=None):
        from pint_tpu_torch.device import resolve_device

        if max_sessions is None:
            max_sessions = int(
                os.environ.get("PINT_TPU_SERVE_SESSIONS", "32")
            )
        if max_pars is None:
            max_pars = int(
                os.environ.get("PINT_TPU_SERVE_PARS", "1024")
            )
        self.device = resolve_device(device)
        self.max_sessions = max(1, int(max_sessions))
        self.max_pars = max(1, int(max_pars))
        self._lock = lockwitness.wrap(
            threading.Lock(), "SessionCache._lock"
        )
        self._sessions: OrderedDict = OrderedDict()
        self._records: OrderedDict = OrderedDict()
        m = _obs.metrics
        self._hits = m.counter("serve.session.hits")
        self._misses = m.counter("serve.session.misses")
        self._evictions = m.counter("serve.session.evictions")
        self._par_hits = m.counter("serve.session.par_hits")
        self._par_misses = m.counter("serve.session.par_misses")
        self._par_evictions = m.counter("serve.session.par_evictions")
        # population telemetry: distinct pars ever admitted, live
        # record/composition counts — registered so they show in
        # snapshots and flight reports from the first request
        self._pars_served = m.counter("serve.session.pars_served")
        self._g_pars = m.gauge("serve.session.pars")
        self._g_comps = m.gauge("serve.session.compositions")
        self._g_pars.set(0)
        self._g_comps.set(0)

    def __len__(self):
        """Live composition sessions (the compiled layer)."""
        with self._lock:
            return len(self._sessions)

    @property
    def npars(self) -> int:
        """Live par records (the lightweight layer)."""
        with self._lock:
            return len(self._records)

    @property
    def ncompositions(self) -> int:
        """Distinct compositions among live sessions."""
        with self._lock:
            return len({comp for comp, _b in self._sessions})

    def _note_sizes_locked(self):
        self._g_pars.set(len(self._records))
        self._g_comps.set(
            len({comp for comp, _b in self._sessions})
        )

    # -- the lightweight per-par layer ------------------------------------
    def record_for(self, par) -> ParRecord:
        """Get-or-parse the per-par record (pure host work)."""
        text = par_text(par)
        phash = par_content_hash(text)
        with self._lock:
            rec = self._records.get(phash)
            if rec is not None:
                self._records.move_to_end(phash)
                self._par_hits.inc()
                return rec
        # built outside the lock (host model parse; the single collector
        # thread is the only writer, so a duplicate build race costs at
        # most one redundant parse)
        self._par_misses.inc()
        self._pars_served.inc()
        rec = ParRecord(text, phash)
        evicted = 0
        with self._lock:
            self._records[phash] = rec
            self._records.move_to_end(phash)
            while len(self._records) > self.max_pars:
                self._records.popitem(last=False)
                evicted += 1
            self._note_sizes_locked()
        if evicted:
            self._par_evictions.inc(evicted)
        return rec

    # -- the compiled composition layer -----------------------------------
    def session_for(self, record: ParRecord, table, cpu_bundle,
                    min_bucket=None) -> Session:
        """Get-or-build the composition session a request of this (par,
        TOA structure) dispatches through.  ``cpu_bundle`` is the
        request's unpadded bundle on the host (:func:`request_bundles`)."""
        bucket = shape_bucket(cpu_bundle.ntoa, min_bucket)
        comp = record.composition_for(cpu_bundle)
        key = (comp, bucket)
        cid = composition_id(comp)
        if cid not in record._joined:
            record._joined.add(cid)
            _obs.metrics.counter(
                f"serve.composition.{cid}.pars"
            ).inc()
        with self._lock:
            s = self._sessions.get(key)
            if s is not None:
                self._sessions.move_to_end(key)
                self._hits.inc()
                return s
        self._misses.inc()
        with TRACER.span(
            "serve:session-build", "serve", bucket=bucket,
            composition=cid, par_hash=record.par_hash,
        ):
            s = Session(record, table, bucket, comp, self.device)
        evicted = []
        with self._lock:
            self._sessions[key] = s
            self._sessions.move_to_end(key)
            while len(self._sessions) > self.max_sessions:
                evicted.append(self._sessions.popitem(last=False))
            self._note_sizes_locked()
        for (_comp, b), old in evicted:
            self._evictions.inc()
            TRACER.event(
                "session-evict", "serve", composition=old.cid, bucket=b
            )
        return s

    def install(self, session: Session) -> Session:
        """Insert a REBUILT session (the warm ledger's replay) unless an
        equivalent one is live — get-or-keep, returning the canonical
        instance, so the first real request of the composition after a
        restart is a session hit on the already warmed programs."""
        key = (session.composition, session.bucket)
        evicted = []
        with self._lock:
            cur = self._sessions.get(key)
            if cur is not None:
                self._sessions.move_to_end(key)
                return cur
            self._sessions[key] = session
            self._sessions.move_to_end(key)
            while len(self._sessions) > self.max_sessions:
                evicted.append(self._sessions.popitem(last=False))
            self._note_sizes_locked()
        for (_comp, b), old in evicted:
            self._evictions.inc()
            TRACER.event(
                "session-evict", "serve", composition=old.cid, bucket=b
            )
        return session

    # -- one-call resolver -------------------------------------------------
    def get_or_create(self, par, toas, min_bucket=None) -> Session:
        """Record + composition session in one call (tests and library
        callers; the engine resolves the two layers itself so the
        request's bundle is built exactly once)."""
        rec = self.record_for(par)
        table = request_table(toas, rec.model)
        cpu, _ = request_bundles(rec.model, table)
        return self.session_for(rec, table, cpu, min_bucket)
