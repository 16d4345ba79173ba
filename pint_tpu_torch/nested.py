"""Nested sampling over the timing likelihood.

Counterpart of ``pint_tpu/nested.py``, a copy of its numpy sampler: an
ellipsoid-rejection nested sampler (Skilling 2004) whose candidates are
proposed in the unit cube, mapped through ``prior_transform`` and scored
in batches of a fixed length, so that one vmapped likelihood program
(``BayesianTiming.sample_nested``: one replay on the card) serves every
call; accepted-but-unused candidates above the current likelihood
threshold are pooled and reused while the threshold allows.

method='multi' (default; nestle's 'multi') recursively splits the live
set with 2-means and keeps the split when the child bounding ellipsoids'
total volume is clearly below the parent's, so a separated multimodal
posterior gets one ellipsoid per mode; method='single' keeps one
bounding ellipsoid.  Multi-ellipsoid proposals draw an ellipsoid by
volume and accept with probability 1/q (q = number of ellipsoids
containing the candidate), so the proposal density stays uniform over
the union.

Returns evidence (logz +- logzerr from the information H), the dead
points with importance weights, and equal-weight posterior samples.
"""

from __future__ import annotations

import numpy as np


def _bounding_ellipsoid(cubes, enlarge):
    """(mean, L) with L the Cholesky factor of the covariance scaled to
    contain every live point, inflated by ``enlarge``."""
    d = cubes.shape[1]
    mean = cubes.mean(axis=0)
    dx = cubes - mean
    cov = dx.T @ dx / max(1, len(cubes) - 1) + 1e-14 * np.eye(d)
    cinv = np.linalg.inv(cov)
    d2 = np.einsum("ij,jk,ik->i", dx, cinv, dx).max()
    return mean, np.linalg.cholesky(cov * d2) * enlarge


def _sample_ellipsoid(rng, mean, L, m):
    d = len(mean)
    z = rng.normal(size=(m, d))
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    r = rng.uniform(size=(m, 1)) ** (1.0 / d)
    return mean + (z * r) @ L.T


def _logvol(L):
    """log volume of the ellipsoid with Cholesky factor L, up to the
    (constant) unit-ball volume — only ratios are ever compared."""
    return float(np.sum(np.log(np.abs(np.diagonal(L)))))


def _kmeans2(pts, iters: int = 12):
    """Deterministic 2-means: seeded by the extremes of the first
    principal axis (the split direction a separated pair of modes
    actually has)."""
    dx = pts - pts.mean(axis=0)
    # leading principal axis via the thin SVD of the centered cloud
    # (nlive x d is small; SVD also behaves on degenerate clouds where
    # a covariance eig could return noise directions)
    _, _, vt = np.linalg.svd(dx, full_matrices=False)
    proj = dx @ vt[0]
    c = np.stack([pts[int(np.argmin(proj))], pts[int(np.argmax(proj))]])
    for _ in range(iters):
        d0 = np.linalg.norm(pts - c[0], axis=1)
        d1 = np.linalg.norm(pts - c[1], axis=1)
        lab = (d1 < d0)
        if lab.all() or (~lab).all():
            break
        c = np.stack([pts[~lab].mean(axis=0), pts[lab].mean(axis=0)])
    return pts[~lab], pts[lab]


def _build_ellipsoids(cubes, enlarge, min_pts, max_depth: int = 6,
                      split_factor: float = 0.5):
    """Recursive multi-ellipsoid decomposition of the live set.  A
    2-means split is kept only when the children's total volume is
    below ``split_factor`` of the parent's — a unimodal cloud splits
    into two halves of roughly the parent volume and is NOT split,
    while separated modes shrink the total by orders of magnitude."""
    ells = []

    def recurse(pts, depth):
        mean, L = _bounding_ellipsoid(pts, enlarge)
        if depth < max_depth and len(pts) >= 2 * min_pts:
            a, b = _kmeans2(pts)
            if min(len(a), len(b)) >= min_pts:
                la = _bounding_ellipsoid(a, enlarge)
                lb = _bounding_ellipsoid(b, enlarge)
                tot = np.logaddexp(_logvol(la[1]), _logvol(lb[1]))
                if tot < _logvol(L) + np.log(split_factor):
                    recurse(a, depth + 1)
                    recurse(b, depth + 1)
                    return
        ells.append((mean, L))

    recurse(np.asarray(cubes), 0)
    return ells


def _sample_multi(rng, ells, m):
    """m candidates uniform over the ellipsoid UNION: draw an
    ellipsoid by volume, sample it, accept with probability 1/q where
    q counts the ellipsoids containing the draw."""
    logv = np.array([_logvol(L) for _, L in ells])
    p = np.exp(logv - logv.max())
    p /= p.sum()
    which = rng.choice(len(ells), size=m, p=p)
    out = np.empty((m, len(ells[0][0])))
    for e, (mean, L) in enumerate(ells):
        sel = which == e
        if sel.any():
            out[sel] = _sample_ellipsoid(rng, mean, L, int(sel.sum()))
    if len(ells) == 1:
        return out
    # multiplicity correction
    q = np.zeros(m)
    for mean, L in ells:
        y = np.linalg.solve(L, (out - mean).T).T
        q += (np.einsum("ij,ij->i", y, y) <= 1.0 + 1e-12)
    keep = rng.uniform(size=m) < 1.0 / np.maximum(q, 1.0)
    return out[keep]


def nested_init(
    loglike_batch,
    prior_transform,
    ndim: int,
    nlive: int = 200,
    batch: int = 128,
    dlogz: float = 0.1,
    max_iter: int = 200000,
    enlarge: float = 1.25,
    seed: int = 0,
    method: str = "multi",
) -> dict:
    """Draw the initial live set and return the full sampler state.

    The state dict is everything nested_iterate/nested_result need —
    live points, dead lists, evidence accumulators, the candidate
    pool, the host RNG, and the run configuration — so a run can be
    segmented at iteration granularity (the background-job quantum,
    and checkpointed between segments (nested_checkpoint_state /
    nested_restore_state) without changing a single RNG draw relative
    to the uninterrupted nested_sample."""
    if method not in ("multi", "single"):
        raise ValueError(f"unknown method {method!r}")
    rng = np.random.default_rng(seed)
    cubes = rng.uniform(size=(nlive, ndim))
    X = np.stack([prior_transform(c) for c in cubes])
    logl = np.array(loglike_batch(X), dtype=np.float64)  # writable copy
    # NaN likelihoods (overflowed residuals at extreme prior draws)
    # are treated as impossible, exactly like -inf; they then die
    # first and carry zero weight (see the logwt guard below)
    logl[np.isnan(logl)] = -np.inf
    return dict(
        rng=rng, cubes=cubes, X=X, logl=logl, ncall=nlive,
        logz=-np.inf, h=0.0, nells_max=0,
        dead_x=[], dead_logl=[], dead_logwt=[],
        pool_c=np.empty((0, ndim)), pool_x=np.empty((0, ndim)),
        pool_l=np.empty(0), it=0, done=False,
        ndim=ndim, nlive=nlive, batch=batch, dlogz=dlogz,
        max_iter=max_iter, enlarge=enlarge, method=method,
    )


def nested_iterate(st: dict, loglike_batch, prior_transform,
                   n_iter: int) -> bool:
    """Advance the sampler by up to ``n_iter`` dead points (in place).
    Returns True when the run has terminated (dlogz criterion or
    max_iter) — call nested_result exactly once after that.  The loop
    body is the former nested_sample interior verbatim, so a chunked
    run is draw-for-draw identical to the monolithic one."""
    rng, nlive, batch = st["rng"], st["nlive"], st["batch"]
    dlogz, enlarge, method = st["dlogz"], st["enlarge"], st["method"]
    ndim = st["ndim"]
    cubes, X, logl = st["cubes"], st["X"], st["logl"]
    pool_c, pool_x, pool_l = st["pool_c"], st["pool_x"], st["pool_l"]
    logz, h, it = st["logz"], st["h"], st["it"]
    end = it + max(0, int(n_iter))
    while it < end and it < st["max_iter"]:
        # termination BEFORE recording the worst point: the remaining
        # evidence is bounded by the max live logl over the current
        # volume; checking here keeps the dead and live sets disjoint
        # (recording then breaking would count the worst point twice —
        # once with its shell weight, once in the live flush below)
        logz_remain = float(logl.max()) - it / nlive
        if (
            np.isfinite(logz)
            and np.logaddexp(logz, logz_remain) - logz < dlogz
        ):
            st["done"] = True
            break
        i_min = int(np.argmin(logl))
        l_min = float(logl[i_min])
        # shell volume between successive prior-volume shrinkages
        lv0, lv1 = -it / nlive, -(it + 1) / nlive
        logdvol = lv1 + np.log(np.expm1(lv0 - lv1))
        logwt = l_min + logdvol
        if np.isfinite(logwt):
            logz_new = np.logaddexp(logz, logwt)
            prev = (
                np.exp(logz - logz_new) * (h + logz)
                if np.isfinite(logz) else 0.0
            )
            h = np.exp(logwt - logz_new) * l_min + prev - logz_new
            logz = logz_new
        # else: an impossible point (l_min = -inf) carries zero
        # weight — updating H through it would make logzerr NaN
        st["dead_x"].append(X[i_min].copy())
        st["dead_logl"].append(l_min)
        st["dead_logwt"].append(logwt)

        # replacement: pool first (threshold only rises), else propose
        keep = pool_l > l_min
        pool_c, pool_x, pool_l = pool_c[keep], pool_x[keep], pool_l[keep]
        rounds = 0
        ell = None  # live set is invariant until a replacement lands
        while len(pool_l) == 0:
            rounds += 1
            if rounds > 1000:
                # likelihood plateau (or an all-impossible start, or a
                # separated multimodal set under method='single'): no
                # candidate can exceed l_min, so the rejection loop
                # would spin forever — fail loudly with the state
                raise RuntimeError(
                    f"nested_sample: no candidate exceeded logl="
                    f"{l_min!r} after {rounds - 1} proposal rounds "
                    f"({(rounds - 1) * batch} draws) at iteration "
                    f"{it}; the likelihood is flat (or -inf) over "
                    "the sampled region"
                )
            if ell is None:
                if method == "multi":
                    ell = _build_ellipsoids(
                        cubes, enlarge, min_pts=max(2 * ndim, 5)
                    )
                    st["nells_max"] = max(st["nells_max"], len(ell))
                else:
                    ell = [_bounding_ellipsoid(cubes, enlarge)]
                    st["nells_max"] = max(st["nells_max"], 1)
            cand = (
                _sample_multi(rng, ell, batch) if len(ell) > 1
                else _sample_ellipsoid(rng, *ell[0], batch)
            )
            ok = np.all((cand >= 0.0) & (cand < 1.0), axis=1)
            cand = cand[ok]
            if len(cand) == 0:
                continue
            cx = np.stack([prior_transform(c) for c in cand])
            # pad to the fixed batch length so one vectorized
            # likelihood program serves every call (varying survivor
            # counts would otherwise need a program per shape)
            npad = batch - len(cx)
            cx_pad = (
                np.concatenate([cx, np.repeat(cx[:1], npad, axis=0)])
                if npad else cx
            )
            cl = np.asarray(
                loglike_batch(cx_pad), dtype=np.float64
            )[: len(cx)]
            st["ncall"] += len(cx_pad)  # padded rows are evaluated too
            good = cl > l_min
            pool_c, pool_x, pool_l = cand[good], cx[good], cl[good]
        cubes[i_min] = pool_c[0]
        X[i_min] = pool_x[0]
        logl[i_min] = pool_l[0]
        pool_c, pool_x, pool_l = pool_c[1:], pool_x[1:], pool_l[1:]
        it += 1
    else:
        if it >= st["max_iter"]:
            st["done"] = True
    st["pool_c"], st["pool_x"], st["pool_l"] = pool_c, pool_x, pool_l
    st["logz"], st["h"], st["it"] = logz, h, it
    return st["done"]


def nested_result(st: dict) -> dict:
    """Flush the final live points into the dead set and build the
    result dict (the former nested_sample epilogue; consumes the state
    RNG for the equal-weight resampling — call once)."""
    nlive, it = st["nlive"], st["it"]
    X, logl = st["X"], st["logl"]
    logz, h = st["logz"], st["h"]
    dead_x = list(st["dead_x"])
    dead_logl = list(st["dead_logl"])
    dead_logwt = list(st["dead_logwt"])
    # final live points: each carries 1/nlive of the remaining volume
    logdvol = -it / nlive - np.log(nlive)
    for j in range(nlive):
        logwt = float(logl[j]) + logdvol
        if np.isfinite(logwt):
            logz_new = np.logaddexp(logz, logwt)
            prev = (
                np.exp(logz - logz_new) * (h + logz)
                if np.isfinite(logz) else 0.0
            )
            h = (np.exp(logwt - logz_new) * float(logl[j])
                 + prev - logz_new)
            logz = logz_new
        dead_x.append(X[j].copy())
        dead_logl.append(float(logl[j]))
        dead_logwt.append(logwt)

    dead_x = np.stack(dead_x)
    dead_logl = np.asarray(dead_logl)
    dead_logwt = np.asarray(dead_logwt)
    logzerr = float(np.sqrt(max(h, 0.0) / nlive))
    # equal-weight posterior resampling
    p = np.exp(dead_logwt - dead_logwt.max())
    p /= p.sum()
    neff = int(1.0 / np.sum(p * p))
    idx = st["rng"].choice(len(p), size=max(neff, 1), p=p)
    return dict(
        logz=float(logz), logzerr=logzerr, h=float(h), niter=it,
        ncall=int(st["ncall"]), samples=dead_x[idx], samples_raw=dead_x,
        logwt=dead_logwt, logl=dead_logl,
        nells=max(st["nells_max"], 1),
    )


_NESTED_SCALARS = (
    "ncall", "logz", "h", "nells_max", "it", "done", "ndim", "nlive",
    "batch", "dlogz", "max_iter", "enlarge", "method",
)
_NESTED_ARRAYS = ("cubes", "X", "logl", "pool_c", "pool_x", "pool_l")
_NESTED_LISTS = ("dead_logl", "dead_logwt")


def nested_checkpoint_state(st: dict) -> dict:
    """State -> a flat npz-able payload.  The
    host Generator serializes via its bit_generator state dict (rides
    as a pickled object array); dead_x keeps its per-point list
    structure as a stacked array + count."""
    out = {"rng_state": st["rng"].bit_generator.state}
    for k in _NESTED_SCALARS:
        out[k] = st[k]
    for k in _NESTED_ARRAYS:
        out[k] = np.asarray(st[k])
    for k in _NESTED_LISTS:
        out[k] = np.asarray(st[k], dtype=np.float64)
    out["n_dead"] = len(st["dead_x"])
    out["dead_x"] = (
        np.stack(st["dead_x"]) if st["dead_x"]
        else np.empty((0, st["ndim"]))
    )
    return out


def nested_restore_state(payload: dict) -> dict:
    """Inverse of nested_checkpoint_state — the restored state resumes
    draw-for-draw where the checkpoint left off."""
    st = {}
    for k in _NESTED_SCALARS:
        v = payload[k]
        v = v.item() if hasattr(v, "item") else v
        st[k] = str(v) if k == "method" else v
    st["it"] = int(st["it"])
    st["done"] = bool(st["done"])
    for k in ("ndim", "nlive", "batch", "max_iter", "ncall",
              "nells_max"):
        st[k] = int(st[k])
    for k in _NESTED_ARRAYS:
        st[k] = np.array(payload[k], dtype=np.float64)
    for k in _NESTED_LISTS:
        st[k] = [float(v) for v in np.asarray(payload[k])]
    st["dead_x"] = [
        row.copy() for row in np.asarray(payload["dead_x"],
                                         dtype=np.float64)
    ]
    rng = np.random.default_rng(0)
    rng.bit_generator.state = payload["rng_state"]
    st["rng"] = rng
    return st


def nested_sample(
    loglike_batch,
    prior_transform,
    ndim: int,
    nlive: int = 200,
    batch: int = 128,
    dlogz: float = 0.1,
    max_iter: int = 200000,
    enlarge: float = 1.25,
    seed: int = 0,
    method: str = "multi",
):
    """Run ellipsoid-rejection nested sampling.

    loglike_batch: (m, ndim) parameter array -> (m,) log-likelihoods
      (wrap a vmapped likelihood program; called with full parameter
      vectors from prior_transform).
    prior_transform: unit-cube vector -> parameter vector (the
      BayesianTiming.prior_transform contract).
    method: 'multi' (default; recursive 2-means ellipsoid
      decomposition, handles separated multimodal posteriors) or
      'single' (one bounding ellipsoid — nestle's 'single').

    Composed of nested_init / nested_iterate / nested_result, so a run
    executed in segments is draw for draw this one.

    Returns a dict with logz, logzerr, niter, ncall, samples
    (equal-weight posterior), samples_raw, logwt, logl, and nells
    (max simultaneous ellipsoid count seen — 1 for unimodal runs).
    """
    st = nested_init(
        loglike_batch, prior_transform, ndim, nlive=nlive, batch=batch,
        dlogz=dlogz, max_iter=max_iter, enlarge=enlarge, seed=seed,
        method=method,
    )
    while not nested_iterate(st, loglike_batch, prior_transform,
                             max_iter):
        pass
    return nested_result(st)
