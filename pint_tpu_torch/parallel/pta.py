"""PTA-scale batching: one batched step for every pulsar of an array.

Counterpart of ``pint_tpu/parallel/pta.py``.  The pulsars share one
model composition (the same free-parameter layout, mask keys, noise-basis
structure and host-read values); their TOA counts may differ, and the
shorter ones are padded with TOAs of ~infinite error (``PAD_ERROR_US``)
that carry no statistical weight.  Each pulsar's state rides a leading
pulsar axis: its bundle, its reference values (the x = 0 anchor of its
own delta vector, epochs included as device scalars), and the host
angles its astrometry is taken about.  ``torch.func.vmap`` runs the
first pulsar's compiled model over that axis with each pulsar's state
swapped in, so a step is one batched computation; in ``'mixed'`` mode its
joint Gram is ONE launch of the CUDA kernel for all pulsars
(``ops/fused_gram.py``'s vmap rule).  ``shard`` (the multi-GPU mesh) is
ROADMAP A8.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from pint_tpu_torch.device import F64
from pint_tpu_torch.exceptions import PintTpuError
from pint_tpu_torch.fitting.base import noffset
from pint_tpu_torch.fitting.gls import default_accel_mode, gauss_newton_step
from pint_tpu_torch.models.timing_model import device_anchors, split_ref
from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.runtime.graphs import ProgramCache, flatten
from pint_tpu_torch.toas.bundle import TOABundle

#: Uncertainty of a padded TOA (microseconds), the reference's: its
#: weight 1/(1e12 s)^2 = 1e-24 s^-2 is ~1e-36 of a 1-us TOA's, ~25
#: decades under f64 roundoff, while sigma^2 = 1e24 s^2 and 1/sigma^2 stay
#: far inside the f32 range that the mixed step's Gram values take.
PAD_ERROR_US = 1e18


def _pad_rows(x: torch.Tensor, cur: int, pad: int) -> torch.Tensor:
    """Repeat the last row of a per-TOA tensor ``pad`` times."""
    if x.dim() >= 1 and x.shape[0] == cur:
        return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], dim=0)
    return x


def pad_bundle_to(bundle: TOABundle, n: int) -> TOABundle:
    """Pad the TOA axis to length n by repeating the last TOA with
    ~infinite error (zero statistical weight).  The TZR row is the
    model's and stays as it is."""
    cur = bundle.ntoa
    if cur == n:
        return bundle
    if cur > n:
        raise PintTpuError(f"cannot pad {cur} TOAs down to {n}")
    pad = n - cur

    def p(v):
        if v is None:
            return None
        if isinstance(v, DD):
            return DD(p(v.hi), p(v.lo))
        if isinstance(v, dict):
            return {k: p(a) for k, a in v.items()}
        return _pad_rows(v, cur, pad)

    out = bundle._replace(**{f: p(getattr(bundle, f))
                             for f in bundle._fields if f != "tzr"})
    err = torch.cat([bundle.error_us, torch.full(
        (pad,), PAD_ERROR_US, dtype=F64, device=bundle.device)])
    return out._replace(error_us=err)


def _stack(trees):
    """Stack equally structured trees leaf by leaf on a new axis 0."""
    flats = [flatten(t) for t in trees]
    leaves = [torch.stack(ls) for ls in zip(*(f[0] for f in flats))]
    return flats[0][1](leaves)


def _structure(tree):
    """A tree's structure and leaf shapes, for comparing pulsars."""
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape)
    if isinstance(tree, dict):
        return tuple(sorted((k, _structure(v)) for k, v in tree.items()))
    if isinstance(tree, tuple):
        return (type(tree).__name__,) + tuple(_structure(v) for v in tree)
    return repr(tree)


class PTABatch:
    """A pulsar-axis batch over per-pulsar CompiledModels (one device)."""

    def __init__(self, cms: list):
        if not cms:
            raise PintTpuError("empty PTA batch")
        proto = cms[0]
        names = proto.free_names
        for cm in cms[1:]:
            if cm.free_names != names:
                raise PintTpuError(
                    "PTA batch needs identical free-parameter layouts: "
                    f"{names} vs {cm.free_names}"
                )
            if cm.device != proto.device:
                raise PintTpuError("PTA batch needs one device for all "
                                   f"pulsars: {proto.device} vs {cm.device}")
            if set(cm.bundle.masks) != set(proto.bundle.masks):
                raise PintTpuError("PTA batch needs identical mask keys")
            for k, v0 in proto.bundle.masks.items():
                v = cm.bundle.masks[k]
                if v.shape[1:] != v0.shape[1:]:
                    raise PintTpuError(
                        "PTA batch needs identical noise-basis/mask "
                        f"structure: mask {k!r} is {tuple(v0.shape)} vs "
                        f"{tuple(v.shape)} — match TNREDC / ECORR epoch "
                        "structures across pulsars"
                    )
        self.cms = cms
        self.free_names = names
        self.npulsars = len(cms)
        self.device = proto.device
        self._proto = proto
        # per-pulsar reference values become batched data: each pulsar's
        # x is a delta from ITS OWN par values
        refs = [split_ref(cm.ref, cm.device) for cm in cms]
        num0, static0 = refs[0]
        for num, static in refs[1:]:
            if _structure(num) != _structure(num0):
                raise PintTpuError(
                    "PTA batch needs identical numeric parameter sets"
                )
            if static != static0:
                raise PintTpuError(
                    "PTA batch needs identical static (string/bool/pair) "
                    f"parameters: {static} vs {static0}"
                )
        # what the kernels read on the host at call time must agree, or
        # the prototype's would silently replace each pulsar's own
        def host_reads(cm):
            return [(n, c.host_state())
                    for n, c in cm.model.components.items()]

        a = host_reads(proto)
        for i, cm in enumerate(cms[1:], start=1):
            b = host_reads(cm)
            if a != b:
                raise PintTpuError(
                    "PTA batch needs identical components and host-read "
                    f"values (pulsar 0: {a}, pulsar {i}: {b})"
                )
            if cm.track_mode != proto.track_mode:
                raise PintTpuError(
                    "PTA batch needs one pulse-tracking mode (pulse numbers "
                    "for all pulsars or for none)"
                )

        def basis_cols(cm):
            T, phi = cm.noise_basis_or_empty(cm.x0())
            return tuple(T.shape[1:]), tuple(phi.shape)

        k0 = basis_cols(proto)
        for i, cm in enumerate(cms[1:], start=1):
            ki = basis_cols(cm)
            if ki != k0:
                raise PintTpuError(
                    "PTA batch needs identical noise-basis structure "
                    f"(pulsar 0: {k0}, pulsar {i}: {ki}) — match TNREDC"
                    " / ECORR epoch structures across pulsars"
                )
        nmax = max(cm.bundle.ntoa for cm in cms)
        self.ntoa = nmax
        padded = [pad_bundle_to(cm.bundle, nmax) for cm in cms]
        if len({_structure(b) for b in padded}) != 1:
            raise PintTpuError("PTA batch needs identical TOA-bundle "
                               "structure (TZR rows, DM measurements, "
                               "planet columns)")
        self.bundle = _stack(padded)
        self._static = static0
        proto._pdict(proto.x0())  # the flat-vector layout of the refs
        flat_names = proto._flat_names
        self.ref = _stack([
            {**num, **device_anchors(cm.model, cm.device)}
            for cm, (num, _) in zip(cms, refs)])
        self.flat_ref = torch.tensor(
            [[float(cm.ref[n]) for n in flat_names] for cm in cms],
            dtype=F64, device=self.device)
        # the batch keeps the reference values it was built with, so its
        # step programs stay valid across commit()
        self.programs = ProgramCache(self.device)

    # -- batched kernels --------------------------------------------------
    def _vmapped(self, fn):
        """``fn(proto_cm, x_i)`` over the pulsar axis with each pulsar's
        bundle and reference values swapped into the prototype (they are
        what its kernels read off the instance).  The result holds no
        reference to the batch, so a program of it in the batch's cache
        makes no cycle."""
        proto, static = self._proto, self._static
        leaves, rebuild = flatten((self.bundle, self.ref, self.flat_ref))

        def call(xs_i, *ls):
            bundle, ref, flat = rebuild(ls)
            saved = proto.bundle, proto._ref_dev, proto._flat_ref
            proto.bundle = bundle
            proto._ref_dev = {**static, **ref}
            proto._flat_ref = flat
            try:
                return fn(proto, xs_i)
            finally:
                proto.bundle, proto._ref_dev, proto._flat_ref = saved

        return lambda xs: vmap(call)(xs, *leaves)

    def x0(self):
        return torch.zeros((self.npulsars, len(self.free_names)), dtype=F64,
                           device=self.device)

    def residuals(self, xs):
        """(P, n) time residuals (no mean subtraction)."""
        return self._vmapped(
            lambda cm, x: cm.time_residuals(x, subtract_mean=False))(xs)

    def chi2(self, xs):
        """(P,) white chi2 of each pulsar."""
        return self._vmapped(lambda cm, x: cm.chi2(x))(xs)

    def _step_mode(self) -> str:
        """GLSFitter's policy: mixed on the card for correlated noise,
        f64 otherwise."""
        return default_accel_mode(self._proto)

    def _step_fn(self, mode: str | None):
        """The batched step of ``mode`` as a function of xs."""
        no = noffset(self._proto)
        mode = mode or self._step_mode()
        if mode not in ("mixed", "f64"):
            raise PintTpuError(
                f"unknown PTA fit mode {mode!r}: expected 'mixed' or "
                "'f64'"
            )

        def single(cm, x):
            xn, (covn, nrm), chi2, _ = gauss_newton_step(cm, x, mode)
            return xn, chi2, (covn[no:, no:], nrm[no:])

        return self._vmapped(single)

    def fit_step(self, xs, mode: str | None = None):
        """One batched GLS Gauss-Newton step for every pulsar, run
        eagerly: -> (new xs (P, p), chi2 (P,), (covn (P, p, p),
        norm (P, p))).  ``mode``: 'mixed' | 'f64' | None (the GLSFitter
        policy)."""
        return self._step_fn(mode)(xs)

    def fit(self, maxiter: int = 3, mode: str | None = None):
        """``maxiter`` batched steps from the par values, then the
        covariance at the result (the steps' own is one step stale), as
        ``maxiter + 1`` replays of one step program with no host read
        between them (the reference's scan): -> (xs (P, p), chi2 (P,)).
        ``self.cov`` holds the (P, p, p) covariances, unnormalized on the
        host; ``self.steps_taken`` the batched steps run."""
        if maxiter < 1:
            raise PintTpuError("PTABatch.fit needs maxiter >= 1")
        mode = mode or self._step_mode()
        # the batch's step program (runtime/graphs.py: replayed CUDA
        # graphs on the card), the counterpart of the reference's jitted
        # scan body
        step = self.programs.program(self._step_fn(mode),
                                     ("pta", mode, self.npulsars, self.ntoa))
        xs = self.x0()
        for _ in range(maxiter):
            xs, chi2, _ = step(xs)
        _, _, (covn, nrm) = step(xs)
        self.steps_taken = maxiter + 1
        covn, nrm = covn.cpu().numpy(), nrm.cpu().numpy()
        self.cov = covn / (nrm[:, :, None] * nrm[:, None, :])
        return xs, chi2

    def commit(self, xs, covs=None):
        """Fold fitted deltas back into each pulsar's host model, with
        uncertainties from covs (P, p, p), by default the last fit's.
        The batch keeps the reference values it was built with."""
        if covs is None:
            covs = getattr(self, "cov", None)
        xs = xs.detach().cpu().numpy() if torch.is_tensor(xs) else xs
        for i, (cm, x) in enumerate(zip(self.cms, np.asarray(xs))):
            unc = None
            if covs is not None:
                unc = np.sqrt(np.diag(np.asarray(covs)[i]))
            cm.commit(x, uncertainties=unc)

    def shard(self, mesh):
        """Place the batch across several cards: not ported yet."""
        raise NotImplementedError(
            "PTABatch.shard needs the multi-GPU mesh, which is not ported "
            "yet (ROADMAP A8)")
