"""Chi-squared grids over parameter subspaces.

Counterpart of ``pint_tpu/gridutils.py`` (reference parity:
src/pint/gridutils.py::grid_chisq / grid_chisq_derived).  Every grid
point is the same pure function of x: the gridded parameters held at the
point, the other free parameters refit by masked Gauss-Newton (WLS)
steps, then the chi2.  The reference vmaps it over every point at once.
Here ``torch.func.vmap`` runs it over a chunk of points as one step
program (``CompiledModel.program``: CUDA graphs on the card), replayed
once a chunk, the last chunk padded with copies of its last point.  A
point on the binary MSP at 1e5 TOAs holds a ``jacfwd`` over 167 tangents,
so all points at once would not fit the card; :func:`grid_chunk` sizes
the chunk to the free memory.  Each point's arithmetic does not depend
on the chunk it rides in, so the result does not depend on the chunk
size.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from pint_tpu_torch.device import F64
from pint_tpu_torch.fitting.base import design_with_offset, noffset
from pint_tpu_torch.fitting.wls import _wls_step
from pint_tpu_torch.runtime.guard import check_deadlines

#: device bytes a grid point holds at once per TOA and design column: the
#: f64 jacfwd tangents of the double-double residual chain and the WLS
#: solve's copies, ~21x the design matrix (one binary-MSP step program's
#: 2.87 GB pool at 1e5 TOAs and 169 columns, PERF.md section 5), with room
GRID_BYTES_PER_TOA_COLUMN = 8 * 24
#: the share of the card's free memory a grid's chunk may take
GRID_MEMORY_SHARE = 0.4


def _float(v) -> float:
    return float(v.to_float()) if hasattr(v, "to_float") else float(v)


def _internal_value(param, value):
    """A par-file-unit value (a number or a par string) in internal
    units, through a scratch copy of the Parameter."""
    pc = copy.deepcopy(param)
    pc.value = pc._parse_value_str(value) if isinstance(value, str) else value
    iv = pc.internal()
    if isinstance(iv, tuple):
        raise ValueError(
            f"cannot grid epoch parameter {param.name} (grid the delta "
            "in seconds instead)"
        )
    return _float(iv)


def grid_axes(model, grid: dict, free_names, ref):
    """-> (names, axes): the internal-unit delta axis of each gridded
    parameter (par-file-unit values minus the model's reference,
    converted through the Parameter)."""
    names = list(grid)
    for n in names:
        if n not in free_names:
            raise ValueError(
                f"grid parameter {n} must be free in the model"
            )
    refv = {n: _float(ref[n]) for n in names}
    axes = [
        np.asarray(
            [_internal_value(model.params[n], v) - refv[n] for v in vals],
            dtype=np.float64,
        )
        for n, vals in grid.items()
    ]
    return names, axes


def grid_mesh_points(axes):
    """Outer-product the delta axes into the (npts, k) point array."""
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=-1)


def make_chi2_at(cm, gidx, refit: bool = True, n_refit_iter: int = 2):
    """-> chi2_at(deltas (k,)) -> chi2: the gridded parameters held at the
    given internal deltas, the rest refit by masked Gauss-Newton WLS
    steps (``_wls_step``'s method for the device: SVD on the CPU, QR with
    its device-side gate on the card)."""
    dev = cm.device
    gidx_t = torch.as_tensor(np.asarray(gidx, dtype=np.int64), device=dev)
    free_mask = np.ones(cm.nfree)
    free_mask[np.asarray(gidx)] = 0.0
    free_mask_t = torch.as_tensor(free_mask, device=dev)
    no = noffset(cm)

    def chi2_at(deltas):
        x = cm.x0().index_copy(0, gidx_t, deltas)
        if refit:
            for _ in range(n_refit_iter):
                r = cm.time_residuals(x, subtract_mean=False)
                M = design_with_offset(cm, x)
                w = 1.0 / torch.square(cm.scaled_sigma(x))
                dx, _, _ = _wls_step(r, M, w)
                x = x + free_mask_t * dx[no:]
        return cm.chi2(x)

    return chi2_at


def grid_chunk(cm, npts: int) -> int:
    """Grid points a chunk takes: every point on the CPU; on the card as
    many as fit in ``GRID_MEMORY_SHARE`` of the free memory at
    ``GRID_BYTES_PER_TOA_COLUMN`` a TOA and design column."""
    if cm.device.type != "cuda":
        return npts
    free, _ = torch.cuda.mem_get_info(cm.device)
    per_point = (cm.bundle.ntoa * (cm.nfree + 1)
                 * GRID_BYTES_PER_TOA_COLUMN)
    return max(1, min(npts, int(GRID_MEMORY_SHARE * free // per_point)))


def _chi2_points(cm, gidx, pts, refit, n_refit_iter, chunk=None):
    """chi2 at each of the (npts, k) delta points: one replay of the
    vmapped ``chi2_at`` program a chunk of ``chunk`` points (None:
    :func:`grid_chunk`), the last chunk padded with its last point."""
    pts = np.asarray(pts, dtype=np.float64)
    npts = len(pts)
    chunk = grid_chunk(cm, npts) if chunk is None else int(chunk)
    key = ("grid", tuple(int(i) for i in gidx), bool(refit),
           int(n_refit_iter), chunk)
    prog = cm.program(
        torch.func.vmap(make_chi2_at(cm, gidx, refit, n_refit_iter)), key)
    out = []
    for lo in range(0, npts, chunk):
        block = pts[lo:lo + chunk]
        pad = chunk - len(block)
        if pad:
            block = np.concatenate([block, np.repeat(block[-1:], pad, 0)])
        out.append(prog(torch.as_tensor(block, device=cm.device))
                   [:chunk - pad])
    # the grid's one host read: its chunks' deadlines polled first (a
    # wedged chunk raises GuardTimeout; none stays queued on this thread
    # holding the program, and its graphs' memory, alive)
    check_deadlines(wait=True)
    return torch.cat(out).to(F64).cpu().numpy()


def grid_chisq(
    toas,
    model,
    grid: dict,
    refit: bool = True,
    n_refit_iter: int = 2,
    *,
    device=None,
    chunk=None,
):
    """chi2 over the outer product of ``grid`` (param name -> values in
    the parameter's par-file units, numbers or par strings).

    Gridded parameters must be free in the model (they are held fixed
    per point; the remaining free parameters are refit when ``refit``).
    Returns the chi2 ndarray with one axis per grid param, in dict order.
    ``device`` (None: the CUDA card), ``chunk`` (None: :func:`grid_chunk`)
    are keyword-only."""
    cm = model.compile(toas, device=device)
    names, axes = grid_axes(model, grid, cm.free_names, cm.ref)
    gidx = [cm._index[n] for n in names]
    pts = grid_mesh_points(axes)  # (npts, k)
    chi2 = _chi2_points(cm, gidx, pts, refit, n_refit_iter, chunk)
    return chi2.reshape([len(a) for a in axes])


def grid_chisq_derived(
    toas, model, param_names, derived_fn, grids,
    refit: bool = True, n_refit_iter: int = 2, *, device=None, chunk=None,
):
    """Grid over derived coordinates: ``derived_fn`` maps grid
    coordinates -> dict of model-parameter values (reference:
    grid_chisq_derived).  ``grids``: one 1-D array per derived
    coordinate.  The points map to internal deltas on the host, then
    evaluate as :func:`grid_chisq`'s do."""
    cm = model.compile(toas, device=device)
    for n in param_names:
        if n not in cm.free_names:
            raise ValueError(
                f"grid parameter {n} must be free in the model"
            )
    gidx = [cm._index[n] for n in param_names]
    ref = {n: _float(cm.ref[n]) for n in param_names}
    mesh = np.meshgrid(*grids, indexing="ij")
    shape = mesh[0].shape
    flat = [m.ravel() for m in mesh]
    pts = np.empty((len(flat[0]), len(param_names)))
    for i in range(len(flat[0])):
        values = derived_fn(*(f[i] for f in flat))
        pts[i] = [
            _internal_value(model.params[n], values[n]) - ref[n]
            for n in param_names
        ]
    chi2 = _chi2_points(cm, gidx, pts, refit, n_refit_iter, chunk)
    return chi2.reshape(shape)
