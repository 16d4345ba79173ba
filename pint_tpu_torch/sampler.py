"""Ensemble MCMC sampler (Goodman & Weare stretch moves) and MCMCFitter.

Counterpart of ``pint_tpu/sampler.py`` (reference parity:
src/pint/sampler.py::EmceeSampler + mcmc_fitter.py::MCMCFitter).  The
reference advances the ensemble in one ``lax.scan`` with the posterior
vmapped over walkers.  Here each step is one step program
(``runtime/graphs.py``): the two half-ensemble proposals, the vmapped
log-posterior of each half and the accept/where, captured as CUDA graphs
on the card and replayed once a step.  The chain stays on the device
and is read once, at the end.

The draws are kept apart from the math: a step takes its six draw
vectors (for each half the stretch uniforms, the partner indices and the
acceptance uniforms) as inputs, so the same step runs on the port's
draws or on draws injected from elsewhere.  The port's draws of step i
come from a ``torch.Generator`` on the walkers' device seeded by a
function of ``(seed, nsteps_total, i)`` alone: the reference's planned
key schedule (``ensemble_keys``) becomes a generator schedule, and a run
cut into segments is bitwise equal to the run without cuts.  The
generators' streams are the device's (Philox on the card, Mersenne
Twister on the CPU), so the card's chain and the CPU's differ for one
seed; from the same draws they agree.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from pint_tpu_torch.device import F64, resolve_device
from pint_tpu_torch.runtime.graphs import StepProgram


def _on(a, device, dtype=F64) -> torch.Tensor:
    """``a`` (a tensor, numpy array or number) as a tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), device=device).to(dtype)


def _seed_of(*words) -> int:
    """A 64-bit generator seed that is a function of ``words`` alone."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)
    return int(state[0])


def ensemble_init(
    x0,
    nwalkers: int = 64,
    seed: int = 0,
    init_scale=1e-8,
    init_cov=None,
    init_walkers=None,
    *,
    device=None,
):
    """The initial ensemble and the schedule's key: -> (walkers
    (nwalkers, ndim) f64 on ``device``, key).  The key is ``seed``: the
    step schedule (:func:`ensemble_keys`) is a function of (seed,
    nsteps_total) only, never of how the ensemble was initialized.  The
    ball is drawn from a generator on ``device`` seeded from ``seed``."""
    dev = resolve_device(device)
    ndim = int(np.asarray(x0).shape[-1])
    if init_walkers is not None:
        walkers = _on(init_walkers, dev)
        if walkers.shape[0] % 2:
            raise ValueError("init_walkers needs an even walker count")
        return walkers, int(seed)
    if nwalkers < 2 * ndim:
        nwalkers = 2 * ndim
    if nwalkers % 2:
        nwalkers += 1
    g = torch.Generator(device=dev)
    g.manual_seed(_seed_of(seed))
    ball = torch.randn((nwalkers, ndim), generator=g, dtype=F64, device=dev)
    x0_t = _on(x0, dev)
    if init_cov is not None:
        C = np.asarray(init_cov, dtype=np.float64)
        C = C + 1e-30 * np.eye(ndim) * np.max(np.diag(C))
        L = torch.linalg.cholesky(_on(C, dev))
        offs = ball @ L.T
    else:
        offs = ball * _on(init_scale, dev)
    return x0_t + offs, int(seed)


def ensemble_keys(key, nsteps: int, nsteps_total=None, start: int = 0):
    """The step seeds [start, start + nsteps) of a planned schedule of
    ``nsteps_total`` steps (None: ``nsteps``, or ``start + nsteps``
    after a completed run): step i's seed is a function of (key,
    nsteps_total, i) alone, so a run cut into segments this way is
    bitwise equal to the uninterrupted one."""
    total = (int(nsteps_total) if nsteps_total is not None
             else start + nsteps)
    if start + nsteps > total:
        raise ValueError(
            f"segment [{start}, {start + nsteps}) exceeds the planned "
            f"schedule of {total} steps"
        )
    return [_seed_of(key, total, i) for i in range(start, start + nsteps)]


def stretch_draws(step_seed: int, half: int, device, generator=None):
    """One step's six draw vectors from a generator on ``device`` seeded
    by ``step_seed``: for the first half, then the second, the stretch
    uniforms (half,), the partner indices in [0, half) and the acceptance
    uniforms."""
    g = generator if generator is not None else torch.Generator(
        device=device)
    g.manual_seed(step_seed)
    out = []
    for _ in range(2):
        out.append(torch.rand(half, generator=g, dtype=F64, device=device))
        out.append(torch.randint(0, half, (half,), generator=g,
                                 device=device))
        out.append(torch.rand(half, generator=g, dtype=F64, device=device))
    return tuple(out)


def make_stretch_step(lnpost_v: Callable, ndim: int, nwalkers: int,
                      a: float = 2.0):
    """One Goodman-Weare ensemble step: (walkers, lp, u_z1, j1, u_acc1,
    u_z2, j2, u_acc2) -> (walkers, lp, n_accepted), the first half moved
    against the second, then the second against the moved first.
    ``lnpost_v`` maps (half, ndim) points to (half,) log-posteriors."""
    half = nwalkers // 2

    def half_step(walkers, lp, u, j, u_acc, first_half: bool):
        if first_half:
            movers, lp_m, others = walkers[:half], lp[:half], walkers[half:]
        else:
            movers, lp_m, others = walkers[half:], lp[half:], walkers[:half]
        # stretch move: z ~ g(z) = 1/sqrt(z) on [1/a, a]
        z = torch.square((a - 1.0) * u + 1.0) / a
        oj = others.index_select(0, j)
        proposal = oj + z[:, None] * (movers - oj)
        lp_prop = lnpost_v(proposal)
        ln_accept = (ndim - 1.0) * torch.log(z) + lp_prop - lp_m
        accept = torch.log(u_acc) < ln_accept
        new_m = torch.where(accept[:, None], proposal, movers)
        new_lp_m = torch.where(accept, lp_prop, lp_m)
        if first_half:
            walkers = torch.cat([new_m, walkers[half:]])
            lp = torch.cat([new_lp_m, lp[half:]])
        else:
            walkers = torch.cat([walkers[:half], new_m])
            lp = torch.cat([lp[:half], new_lp_m])
        return walkers, lp, torch.sum(accept)

    def step(walkers, lp, u1, j1, a1, u2, j2, a2):
        walkers, lp, acc1 = half_step(walkers, lp, u1, j1, a1, True)
        walkers, lp, acc2 = half_step(walkers, lp, u2, j2, a2, False)
        return walkers, lp, acc1 + acc2

    return step


def run_ensemble(
    lnpost: Callable,
    x0: np.ndarray,
    nwalkers: int = 64,
    nsteps: int = 1000,
    a: float = 2.0,
    seed: int = 0,
    init_scale=1e-8,
    init_cov=None,
    init_walkers=None,
    init_lp=None,
    nsteps_total=None,
    start: int = 0,
    *,
    device=None,
    programs=None,
    draws=None,
):
    """Sample ``lnpost`` (a function of one (ndim,) f64 tensor, vmap-safe)
    with stretch moves on ``device`` (None: the CUDA card).

    Walkers start at ``init_walkers`` when given, else in a ball shaped by
    ``init_cov``, else isotropic ``init_scale``.  Resume contract
    (:func:`ensemble_keys`): a run planned as ``nsteps_total`` steps may
    run as segments (``start``, ``init_walkers``, ``init_lp``) whose
    concatenation equals the uninterrupted run bit for bit.

    Every step is one replay of a step program: from ``programs`` (a
    ``ProgramCache``, e.g. a compiled model's) when given, else a program
    of this call.  ``draws`` replaces the generator schedule: step i of
    the segment takes the six vectors ``draws[i]``.

    Returns (chain (nsteps, nwalkers, ndim), lnp (nsteps, nwalkers),
    acceptance_fraction), numpy, read from the device once."""
    dev = resolve_device(device)
    walkers, key = ensemble_init(
        x0, nwalkers=nwalkers, seed=seed, init_scale=init_scale,
        init_cov=init_cov, init_walkers=init_walkers, device=dev,
    )
    nwalkers, ndim = int(walkers.shape[0]), int(walkers.shape[1])
    half = nwalkers // 2
    lnpost_v = torch.func.vmap(lnpost)
    lp = lnpost_v(walkers) if init_lp is None else _on(init_lp, dev)
    step = make_stretch_step(lnpost_v, ndim, nwalkers, a)
    key_ = ("stretch", nwalkers, ndim, float(a), lnpost)
    prog = (programs.program(step, key_) if programs is not None
            else StepProgram(step, dev))
    seeds = ensemble_keys(key, nsteps, nsteps_total, start)
    chain = torch.empty((nsteps, nwalkers, ndim), dtype=F64, device=dev)
    lnp = torch.empty((nsteps, nwalkers), dtype=F64, device=dev)
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev)
    for i in range(nsteps):
        if draws is None:
            d = stretch_draws(seeds[i], half, dev, gen)
        else:  # (u, j, u_acc) for each half: j an index
            d = tuple(_on(v, dev, torch.int64 if k % 3 == 1 else F64)
                      for k, v in enumerate(draws[i]))
        walkers, lp, nacc = prog(walkers, lp, *d)
        chain[i] = walkers
        lnp[i] = lp
        acc += nacc
    return (
        chain.cpu().numpy(),
        lnp.cpu().numpy(),
        float(acc.item()) / (nsteps * nwalkers),
    )


def integrated_autocorr_time(chain, c: float = 5.0):
    """Per-parameter integrated autocorrelation time of an ensemble
    chain (nsteps, nwalkers, ndim), emcee's ``get_autocorr_time``: FFT
    autocorrelation per walker, averaged over the ensemble, summed under
    Sokal's adaptive window (M = min m with m >= c * tau(m))."""
    x = np.asarray(chain, dtype=np.float64)
    n, w, d = x.shape
    nfft = 1 << (2 * n - 1).bit_length()
    taus = np.empty(d)
    for j in range(d):
        xm = x[:, :, j] - x[:, :, j].mean(axis=0, keepdims=True)
        f = np.fft.rfft(xm, n=nfft, axis=0)
        acf = np.fft.irfft(f * np.conjugate(f), n=nfft, axis=0)[:n].real
        var0 = acf[0].copy()
        var0[var0 == 0.0] = 1.0  # frozen walker column: rho := 0
        rho = (acf / var0[None, :]).mean(axis=1)
        tau_m = 2.0 * np.cumsum(rho) - 1.0
        m = np.arange(len(tau_m))
        win = np.argmax(m >= c * tau_m)
        if m[win] < c * tau_m[win]:  # window never satisfied
            win = len(tau_m) - 1
        taus[j] = max(tau_m[win], 1.0)
    return taus


def effective_sample_size(chain, c: float = 5.0):
    """Per-parameter ESS = nsteps * nwalkers / tau."""
    x = np.asarray(chain)
    return x.shape[0] * x.shape[1] / integrated_autocorr_time(x, c)


def gelman_rubin(chain):
    """Per-parameter split-R-hat over the ensemble: each walker chain is
    split in half, giving 2 * nwalkers sequences; values near 1 indicate
    mixing, above ~1.05 an unconverged chain."""
    x = np.asarray(chain, dtype=np.float64)
    n2 = (x.shape[0] // 2) * 2
    # (n/2, 2*nwalkers, d) split sequences
    seq = np.concatenate([x[: n2 // 2], x[n2 // 2: n2]], axis=1)
    n, m, d = seq.shape
    means = seq.mean(axis=0)            # (m, d)
    varis = seq.var(axis=0, ddof=1)     # (m, d)
    W = varis.mean(axis=0)
    B = n * means.var(axis=0, ddof=1)
    W = np.where(W == 0.0, 1e-300, W)
    return np.sqrt((n - 1) / n + B / (n * W))


class MCMCFitter:
    """Posterior sampling over a compiled timing model (reference:
    mcmc_fitter.MCMCFitter).  Every step is a replay of one step program
    of the compiled model (``bt.cm.programs`` counts them).
    ``convergence_diagnostics()`` reports each parameter's integrated
    autocorrelation time, ESS and split-R-hat; ``get_posterior_samples``
    warns when the chain is shorter than 50 autocorrelation times or
    split-R-hat exceeds 1.05."""

    def __init__(self, toas, model, priors: Optional[dict] = None, *,
                 device=None):
        from pint_tpu_torch.bayesian import BayesianTiming

        self.bt = BayesianTiming(model, toas, priors=priors, device=device)
        self.device = self.bt.device
        self.model = model
        self.toas = toas
        self.chain = None
        self.lnp = None
        self.acceptance = None

    def _init_cov(self):
        """The Gauss-Newton covariance at x = 0, which shapes the initial
        ensemble (parameter scales span ~15 decades).  The offset column
        is the fitters' (``design_with_offset``); the covariance comes
        back normalized and is unnormalized on the host."""
        from pint_tpu_torch.fitting.base import design_with_offset, noffset
        from pint_tpu_torch.fitting.wls import _wls_step

        cm = self.bt.cm
        x = cm.x0()
        M = design_with_offset(cm, x)
        w = 1.0 / torch.square(cm.scaled_sigma(x))
        _, (covn, norm), _ = _wls_step(
            torch.zeros(cm.bundle.ntoa, dtype=F64, device=cm.device), M, w,
            normalized_cov=True)
        covn, norm = covn.cpu().numpy(), norm.cpu().numpy()
        cov = covn / np.outer(norm, norm)
        no = noffset(cm)
        return cov[no:, no:]

    def fit_toas(
        self, nsteps: int = 1000, nwalkers: int = 64, burn: float = 0.25,
        seed: int = 0,
    ) -> float:
        chain, lnp, acc = run_ensemble(
            self.bt.lnposterior, np.zeros(self.bt.nparams),
            nwalkers=nwalkers, nsteps=nsteps, seed=seed,
            init_cov=self._init_cov(), device=self.device,
            programs=self.bt.cm.programs,
        )
        self.chain, self.lnp, self.acceptance = chain, lnp, acc
        # where in the planned schedule this chain ends (ensemble_keys)
        self.run_meta = dict(
            seed=seed, nsteps_done=nsteps, nsteps_total=nsteps,
        )
        nburn = int(burn * len(chain))
        flat = chain[nburn:].reshape(-1, self.bt.nparams)
        med = np.median(flat, axis=0)
        std = np.std(flat, axis=0)
        self.bt.cm.commit(med, uncertainties=std)
        i, j = np.unravel_index(np.argmax(lnp), lnp.shape)
        self.maxpost = float(lnp[i, j])
        return self.maxpost

    def convergence_diagnostics(self, burn: float = 0.25) -> dict:
        """{tau, ess, rhat, acceptance, n_post} for the post-burn chain,
        per free parameter in ``cm.free_names`` order."""
        if self.chain is None:
            raise ValueError("run fit_toas first")
        nburn = int(burn * len(self.chain))
        post = self.chain[nburn:]
        return dict(
            tau=integrated_autocorr_time(post),
            ess=effective_sample_size(post),
            rhat=gelman_rubin(post),
            acceptance=self.acceptance,
            n_post=post.shape[0],
        )

    def get_posterior_samples(self, burn: float = 0.25):
        import warnings

        nburn = int(burn * len(self.chain))
        diag = self.convergence_diagnostics(burn)
        names = list(self.bt.cm.free_names)
        short = diag["n_post"] < 50.0 * diag["tau"]
        if short.any():
            bad = [f"{names[i]} (tau={diag['tau'][i]:.0f})"
                   for i in np.nonzero(short)[0]]
            warnings.warn(
                "MCMC chain shorter than 50x the integrated "
                f"autocorrelation time for {', '.join(bad)}; "
                f"posterior summaries are unreliable — run more steps "
                f"(n_post={diag['n_post']})"
            )
        mixed_bad = diag["rhat"] > 1.05
        if mixed_bad.any():
            bad = [f"{names[i]} (R-hat={diag['rhat'][i]:.3f})"
                   for i in np.nonzero(mixed_bad)[0]]
            warnings.warn(
                f"MCMC split-R-hat above 1.05 for {', '.join(bad)}; "
                "walkers have not mixed — run more steps"
            )
        return self.chain[nburn:].reshape(-1, self.bt.nparams)
