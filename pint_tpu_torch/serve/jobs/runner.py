"""Kind-specific job runners: host-side progress and quantum slicing.

Counterpart of ``pint_tpu/serve/jobs/runner.py``.  A runner owns exactly
the state an uninterrupted host-path run of the same computation would
hold (``gridutils.grid_chisq``'s point array and chi2 surface;
``sampler.run_ensemble``'s walkers/lp carry and step-seed schedule;
``nested.nested_sample``'s state dict), advances it one bounded
*quantum* at a time through a station (the scheduler's dispatch handle
for one replica), and round-trips its whole progress through a flat npz
payload (``checkpoint.save_job`` / ``load_job``) — the preemption and
kill-and-restart contract:

- **grid**: the cursor into the deterministic point cloud and the chi2
  rows computed — a resumed grid recomputes nothing.
- **mcmc**: (walkers, lp, cursor) under the planned step-seed schedule
  (``sampler.ensemble_keys``) — a resumed chain continues bitwise as the
  uninterrupted run, because each step's draws are a function of (seed,
  nsteps, step) alone and the carry is fed back exactly.
- **nested**: ``nested.nested_checkpoint_state`` — the host generator
  rides in the payload, so a resumed run is draw for draw the whole one.

The runner never touches a device: ``station.call(key, cap, *host_ops)``
(and ``station.mcmc(...)`` for the MCMC steps) is its only dispatch
surface, so program identity, placement and the stage clock live in one
place (``scheduler._Station``).
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.exceptions import CheckpointError
from pint_tpu_torch.gridutils import grid_axes, grid_chunk, grid_mesh_points
from pint_tpu_torch.models.timing_model import reference_values
from pint_tpu_torch.nested import (
    nested_checkpoint_state,
    nested_init,
    nested_iterate,
    nested_restore_state,
    nested_result,
)
from pint_tpu_torch.sampler import ensemble_init, ensemble_keys

#: per-kind default quantum (grid points / MCMC steps / nested dead
#: points per quantum) — powers of two, so a steady state never builds
GRID_QUANTUM = 256
MCMC_QUANTUM = 64
NESTED_QUANTUM = 8


def pow2_quantum(n: int, lo: int = 8) -> int:
    """A requested quantum rounded up to the power-of-two grid."""
    n = max(int(n), lo)
    return 1 << (n - 1).bit_length()


def _pad_rows(a: np.ndarray, cap: int) -> np.ndarray:
    """A (n, ...) chunk padded to ``cap`` rows by repeating row 0 (the
    program computes the pad; the runner drops it)."""
    n = a.shape[0]
    if n == cap:
        return a
    return np.concatenate([a, np.repeat(a[:1], cap - n, axis=0)])


class GridRunner:
    """grid_chisq as a cursor over the deterministic point cloud."""

    kind = "grid"

    def __init__(self, job, quantum: int | None = None):
        req, rec, sess = job.req, job.record, job.session
        cm = sess.cm
        # the deltas are about the REQUEST's par (its own references),
        # never the session founder's
        self.names, axes = grid_axes(rec.model, req.grid, cm.free_names,
                                     reference_values(rec.model))
        self.shape = tuple(len(a) for a in axes)
        self.pts = grid_mesh_points(axes)  # (npts, k)
        self.npts = int(self.pts.shape[0])
        self.chi2 = np.full(self.npts, np.nan)
        self.cursor = 0
        q = pow2_quantum(quantum or GRID_QUANTUM)
        # on the card, no more points than the free memory holds
        # (gridutils.grid_chunk), rounded down to a power of two
        fit = grid_chunk(cm, q)
        self.quantum = q if fit >= q else 1 << (fit.bit_length() - 1)
        self.key = (
            "job", sess.composition, sess.bucket, "grid",
            tuple(self.names), bool(req.refit), int(req.n_refit_iter),
        )

    @property
    def done(self) -> bool:
        return self.cursor >= self.npts

    def run_quantum(self, station):
        n = min(self.quantum, self.npts - self.cursor)
        chunk = _pad_rows(
            self.pts[self.cursor:self.cursor + n], self.quantum
        )
        out = station.call(self.key, self.quantum, chunk)
        self.chi2[self.cursor:self.cursor + n] = np.asarray(out)[:n]
        self.cursor += n

    def checkpoint_payload(self) -> dict:
        return dict(
            job_kind="grid", npts=self.npts, cursor=self.cursor,
            chi2=self.chi2,
        )

    def restore(self, payload: dict):
        if (
            str(payload.get("job_kind")) != "grid"
            or int(payload["npts"]) != self.npts
        ):
            raise CheckpointError(
                "grid checkpoint does not match the request's grid "
                f"({payload.get('npts')} points saved, {self.npts} "
                "requested)"
            )
        self.cursor = int(payload["cursor"])
        self.chi2 = np.array(payload["chi2"], dtype=np.float64)

    def result(self) -> dict:
        return dict(
            chi2=self.chi2.reshape(self.shape),
            names=tuple(self.names), shape=self.shape,
            npts=self.npts,
        )


class McmcRunner:
    """run_ensemble as (walkers, lp, cursor) under the planned step-seed
    schedule — the bitwise-resume carry."""

    kind = "mcmc"

    def __init__(self, job, quantum: int | None = None):
        req, sess = job.req, job.session
        cm = sess.cm
        self.ndim = int(cm.nfree)
        self.nsteps = int(req.nsteps)
        self.seed = int(req.seed)
        # the initial ensemble exactly as run_ensemble draws it, on the
        # session's device
        walkers, key = ensemble_init(
            np.zeros(self.ndim), nwalkers=int(req.nwalkers),
            seed=self.seed, init_scale=req.init_scale,
            init_cov=req.init_cov, init_walkers=req.init_walkers,
            device=sess.device,
        )
        self.walkers = walkers.cpu().numpy()
        self.nwalkers = int(self.walkers.shape[0])
        # the whole planned schedule, host-held: segments of it are what
        # make preempted runs bitwise
        self.seeds = np.asarray(ensemble_keys(key, self.nsteps),
                                dtype=np.uint64)
        self.lp = None  # seeded by the one-off mcmc0 quantum
        self.cursor = 0
        self.chain_segs: list = []
        self.lnp_segs: list = []
        self.acc = 0
        self.quantum = pow2_quantum(quantum or MCMC_QUANTUM)
        a = float(req.a)
        self.key = (
            "job", sess.composition, sess.bucket, "mcmc",
            self.nwalkers, a, job.prior_tag,
        )
        self.key0 = (
            "job", sess.composition, sess.bucket, "mcmc0",
            self.nwalkers, job.prior_tag,
        )

    @property
    def done(self) -> bool:
        return self.lp is not None and self.cursor >= self.nsteps

    def run_quantum(self, station):
        if self.lp is None:
            # quantum 0: the initial ensemble's log-posteriors (the lp
            # seed run_ensemble computes before its first step)
            out = station.call(self.key0, self.nwalkers, self.walkers)
            self.lp = np.asarray(out)
            return
        n = min(self.quantum, self.nsteps - self.cursor)
        seeds = [int(s) for s in self.seeds[self.cursor:self.cursor + n]]
        wf, lf, chain, lnp, acc = station.mcmc(
            self.key, self.walkers, self.lp, seeds,
        )
        self.walkers = np.asarray(wf)
        self.lp = np.asarray(lf)
        self.chain_segs.append(np.asarray(chain))
        self.lnp_segs.append(np.asarray(lnp))
        self.acc += int(acc)
        self.cursor += n

    def checkpoint_payload(self) -> dict:
        return dict(
            job_kind="mcmc", seed=self.seed, nsteps=self.nsteps,
            nwalkers=self.nwalkers, cursor=self.cursor,
            has_lp=self.lp is not None,
            walkers=self.walkers,
            lp=(self.lp if self.lp is not None
                else np.zeros(self.nwalkers)),
            chain=(
                np.concatenate(self.chain_segs) if self.chain_segs
                else np.zeros((0, self.nwalkers, self.ndim))
            ),
            lnp=(
                np.concatenate(self.lnp_segs) if self.lnp_segs
                else np.zeros((0, self.nwalkers))
            ),
            acc=self.acc,
        )

    def restore(self, payload: dict):
        if (
            str(payload.get("job_kind")) != "mcmc"
            or int(payload["seed"]) != self.seed
            or int(payload["nwalkers"]) != self.nwalkers
            or int(payload["cursor"]) > self.nsteps
        ):
            raise CheckpointError(
                "mcmc checkpoint does not match the request "
                "(seed/walker-count/step plan differ)"
            )
        self.cursor = int(payload["cursor"])
        self.walkers = np.array(payload["walkers"], dtype=np.float64)
        self.lp = (
            np.array(payload["lp"], dtype=np.float64)
            if bool(payload["has_lp"]) else None
        )
        chain = np.array(payload["chain"], dtype=np.float64)
        lnp = np.array(payload["lnp"], dtype=np.float64)
        self.chain_segs = [chain] if len(chain) else []
        self.lnp_segs = [lnp] if len(lnp) else []
        self.acc = int(payload["acc"])

    def result(self) -> dict:
        chain = np.concatenate(self.chain_segs)
        lnp = np.concatenate(self.lnp_segs)
        return dict(
            chain=chain, lnp=lnp,
            acceptance=float(self.acc) / (self.nsteps * self.nwalkers),
        )


class NestedRunner:
    """nested_sample as its own state dict, advanced ``quantum`` dead
    points per quantum; the likelihood batches score on the device
    through the station."""

    kind = "nested"

    def __init__(self, job, quantum: int | None = None):
        req, sess = job.req, job.session
        self.ndim = int(sess.cm.nfree)
        self.req = req
        self.priors = job.priors
        self.names = list(sess.cm.free_names)
        self.batch = pow2_quantum(int(req.batch))
        self.quantum = max(1, int(quantum or NESTED_QUANTUM))
        self.st = None  # built by the first quantum
        self._result = None
        self.key = (
            "job", sess.composition, sess.bucket, "nested",
        )

    def _prior_transform(self, cube):
        return np.array([
            self.priors[n].ppf(cube[i])
            for i, n in enumerate(self.names)
        ])

    def _loglike_batch(self, station):
        def llb(X):
            X = np.asarray(X, dtype=np.float64)
            out = np.empty(len(X))
            for i in range(0, len(X), self.batch):
                chunk = X[i:i + self.batch]
                n = len(chunk)
                scored = station.call(
                    self.key, self.batch, _pad_rows(chunk, self.batch)
                )
                out[i:i + n] = np.asarray(scored)[:n]
            return out

        return llb

    @property
    def done(self) -> bool:
        return self.st is not None and bool(self.st["done"])

    def run_quantum(self, station):
        llb = self._loglike_batch(station)
        if self.st is None:
            r = self.req
            self.st = nested_init(
                llb, self._prior_transform, self.ndim,
                nlive=int(r.nlive), batch=self.batch,
                dlogz=float(r.dlogz), max_iter=int(r.max_iter),
                enlarge=float(r.enlarge), seed=int(r.seed),
                method=str(r.method),
            )
            return
        nested_iterate(
            self.st, llb, self._prior_transform, self.quantum
        )

    def checkpoint_payload(self) -> dict:
        if self.st is None:
            return dict(job_kind="nested", started=False)
        return dict(
            job_kind="nested", started=True,
            **nested_checkpoint_state(self.st),
        )

    def restore(self, payload: dict):
        if str(payload.get("job_kind")) != "nested":
            raise CheckpointError(
                "checkpoint is not a nested-sampling job"
            )
        if not bool(payload["started"]):
            return
        st = nested_restore_state(payload)
        if st["ndim"] != self.ndim or st["nlive"] != int(self.req.nlive):
            raise CheckpointError(
                "nested checkpoint does not match the request "
                "(ndim/nlive differ)"
            )
        self.st = st

    def result(self) -> dict:
        if self._result is None:
            # nested_result consumes the state's generator — once
            self._result = nested_result(self.st)
        return self._result


def make_runner(job, quantum: int | None = None):
    """JobRequest.kind -> runner (admission calls this once the session
    resolves)."""
    kind = job.req.kind
    if kind == "grid_chisq":
        return GridRunner(job, quantum)
    if kind == "mcmc":
        return McmcRunner(job, quantum)
    if kind == "nested":
        return NestedRunner(job, quantum)
    raise ValueError(f"unknown job kind {kind!r}")
