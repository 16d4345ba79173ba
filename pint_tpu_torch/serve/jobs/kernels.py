"""The programs background-job quanta run.

Counterpart of ``pint_tpu/serve/jobs/kernels.py``.  The host-path
sources these batch are ``pint_tpu_torch.gridutils`` and
``pint_tpu_torch.sampler`` / ``bayesian`` / ``nested``.  Each job kind's
device work is a step program of the replica's program cache
(``runtime/graphs.py::ProgramCache``: guarded, on the card captured once
and replayed), keyed per (composition, bucket, kind, kind parameters),
with the job's padded bundle and reference vectors riding as inputs
exactly like interactive serve programs, so a new par of a known
composition builds nothing:

- ``grid``: the vmapped chi2-with-refit of ``gridutils.make_chi2_at``
  over a (quantum, k) chunk of grid points (the host path's body, so the
  two surfaces cannot drift); a short last chunk is padded by repeating
  a row and the runner drops the pad on the host.
- ``mcmc``: ``sampler.make_stretch_step`` over the vmapped posterior, ONE
  step per replay.  A quantum is ``n`` replays of that program, each
  step's six draw vectors made on the device from the planned step seed
  (``sampler.stretch_draws`` of ``sampler.ensemble_keys``) before its
  replay: the reference's ``lax.scan`` over a (q, 2) key array becomes a
  host loop, because a seed set inside a capture would be baked into
  the graph.  A short last quantum replays fewer times (the reference
  masks the dead steps of its scan), so it builds nothing new, and a
  quantum's steps are bitwise ``run_ensemble``'s.
- ``mcmc0``: the vmapped log-posterior of the initial ensemble (the
  ``lp`` seed ``run_ensemble`` computes before its first step).
- ``nested``: the vmapped marginalized log-likelihood batch the nested
  sampler's host loop scores candidates with.

Every program's guard site is ``serve:job:<kind>:b<bucket>x<cap>@<tag>``
(``PINT_TPU_FAULTS`` targets quanta per replica through it).
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.bayesian import lnlikelihood_cm, make_lnprior
from pint_tpu_torch.device import F64
from pint_tpu_torch.exceptions import PintTpuError
from pint_tpu_torch.gridutils import make_chi2_at
from pint_tpu_torch.runtime.graphs import flatten
from pint_tpu_torch.sampler import make_stretch_step, stretch_draws


def job_site(key: tuple, cap: int, tag: str) -> str:
    """The per-replica guard site of one job program."""
    return f"serve:job:{key[3]}:b{int(key[2])}x{int(cap)}@{tag}"


def _lnpost(cm, priors):
    """lnpost(x) over the (swapped) prototype: prior + likelihood, the
    order ``BayesianTiming.lnposterior`` adds them."""
    lnprior = (make_lnprior(priors, list(cm.free_names))
               if priors else None)

    def lnpost(x):
        like = lnlikelihood_cm(cm, x)
        return like if lnprior is None else lnprior(x) + like

    return lnpost


def _body(session, key, priors):
    """One job kind's body as ``call(bundle, refvec, flatvec, *extras)``
    over a private swapped copy of the session's prototype; what the body
    builds ahead of its first call (host tables) is built on that copy."""
    from pint_tpu_torch.serve.session import _swapped

    kind = key[3]
    proto_box = {}

    if kind == "grid":
        names, refit, iters = key[4], bool(key[5]), int(key[6])

        def build(proto):
            gidx = [proto._index[n] for n in names]
            chi2_at = make_chi2_at(proto, gidx, refit, iters)
            return lambda cm, pts: torch.func.vmap(chi2_at)(pts)
    elif kind == "mcmc":
        nwalkers, a = int(key[4]), float(key[5])

        def build(proto):
            step = make_stretch_step(
                torch.func.vmap(_lnpost(proto, priors)), proto.nfree,
                nwalkers, a)
            return lambda cm, walkers, lp, *draws: step(walkers, lp,
                                                        *draws)
    elif kind == "mcmc0":
        def build(proto):
            lnpost_v = torch.func.vmap(_lnpost(proto, priors))
            return lambda cm, walkers: lnpost_v(walkers)
    elif kind == "nested":
        def build(proto):
            like_v = torch.func.vmap(lambda x: lnlikelihood_cm(proto, x))
            return lambda cm, X: like_v(X)
    else:
        raise PintTpuError(f"unknown job kernel kind {kind!r}")

    def fn(cm, *extras):
        return proto_box["fn"](cm, *extras)

    call = _swapped(session, fn)
    proto_box["fn"] = build(call.proto)
    return call


class McmcQuantum:
    """An MCMC quantum: ``n`` replays of the stretch-step program, each
    step's draws made on the device from its planned seed just before its
    replay (``sampler.run_ensemble``'s loop, cut into segments).
    (operand leaves, walkers, lp, seeds) -> (walkers, lp, chain (n, nw,
    ndim), lnp (n, nw), accepted)."""

    def __init__(self, step, nwalkers: int, ndim: int, device):
        self.step = step
        self.nwalkers = nwalkers
        self.ndim = ndim
        self.device = torch.device(device)

    def __call__(self, ops, walkers, lp, seeds):
        dev, n = self.device, len(seeds)
        chain = torch.empty((n, self.nwalkers, self.ndim), dtype=F64,
                            device=dev)
        lnp = torch.empty((n, self.nwalkers), dtype=F64, device=dev)
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        gen = torch.Generator(device=dev)
        half = self.nwalkers // 2
        for i, s in enumerate(seeds):
            d = stretch_draws(int(s), half, dev, gen)
            walkers, lp, nacc = self.step(*ops, walkers, lp, *d)
            chain[i] = walkers
            lnp[i] = lp
            acc += nacc
        return walkers, lp, chain, lnp, acc


def build_job_kernel(session, key: tuple, cap: int, programs, tag: str,
                     priors: dict | None = None, bundle=None):
    """One job program for ``key`` in ``programs`` (a replica's program
    cache), keyed (key, cap): a callable of the placed operand leaves
    (bundle leaves, refvec, flatvec, then the kind's extras).  For
    ``mcmc`` an :class:`McmcQuantum` over the step program, called as
    ``(ops, walkers, lp, seeds)``.  ``bundle`` is any host bundle of the
    session's structure (it fixes the leaf layout)."""
    from pint_tpu_torch.serve.batcher import tree_map

    site = job_site(key, cap, tag)
    leaves, rebuild = flatten(tree_map(lambda a: torch.empty(0), bundle))
    nb = len(leaves)
    call = _body(session, key, priors)

    def run(*ops):
        return call(rebuild(list(ops[:nb])), *ops[nb:])

    prog = programs.program(run, (key, int(cap)), site=site)
    if key[3] == "mcmc":
        return McmcQuantum(prog, int(key[4]), session.cm.nfree,
                           session.device)
    return prog


def synthetic_operands(session, key: tuple, cap: int, host_bundle,
                       refnum) -> tuple:
    """The host operands of one synthetic quantum of ``key`` (the warm
    ledger's replay): the padded prototype bundle, its reference
    vectors, then the kind's extras at their shapes — outputs are
    discarded.  An MCMC entry's extras are a step's (walkers, lp); its
    draws come from a step seed, as a quantum's do."""
    refvec, flatvec = refnum
    ndim = session.cm.nfree
    kind = key[3]
    if kind == "grid":
        extras = (np.zeros((cap, len(key[4]))),)
    elif kind == "mcmc":
        nw = int(key[4])
        extras = (np.zeros((nw, ndim)), np.full(nw, -1.0))
    else:  # mcmc0 / nested: one (cap, ndim) block
        extras = (np.zeros((cap, ndim)),)
    return (host_bundle, refvec, flatvec) + extras


def job_lnposterior(session, bundle, refnum, priors):
    """lnpost(x) of one job's operands (its padded host ``bundle`` and
    reference vectors ``refnum``) on the session's device: the function
    an MCMC job's programs vmap over walkers, so that a job's chain is
    bitwise ``sampler.run_ensemble(job_lnposterior(...), ...)``'s on the
    same seed and device."""
    from pint_tpu_torch.serve.batcher import tree_map
    from pint_tpu_torch.serve.session import _swapped

    dev = session.device
    b = tree_map(lambda a: torch.as_tensor(np.asarray(a), device=dev),
                 bundle)
    refvec, flatvec = (torch.as_tensor(np.asarray(v), device=dev)
                       for v in refnum)
    holder = {}
    call = _swapped(session, lambda cm, x: holder["lnpost"](x))
    holder["lnpost"] = _lnpost(call.proto, priors)
    return lambda x: call(b, refvec, flatvec, x)
