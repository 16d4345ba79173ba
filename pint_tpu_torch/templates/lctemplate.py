"""LCTemplate: weighted sum of primitives + unpulsed background.

Counterpart of ``pint_tpu/templates/lctemplate.py`` (reference parity:
src/pint/templates/lctemplate.py::LCTemplate): f(phi) = sum_i w_i
g_i(phi) + (1 - sum_i w_i), with g_i normalized primitives; parameter
vector layout [w_1..w_n, per-primitive parameters].
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.device import F64, resolve_device
from pint_tpu_torch.templates.lcprimitives import host_tensor


class LCTemplate:
    def __init__(self, primitives, weights=None):
        self.primitives = list(primitives)
        n = len(self.primitives)
        if weights is None:
            weights = np.full(n, 0.5 / n)
        self.weights = np.asarray(weights, dtype=np.float64)
        if self.weights.sum() > 1.0 + 1e-9:
            raise ValueError("primitive weights must sum to <= 1")

    # -- parameter vector -------------------------------------------------
    def get_parameters(self) -> np.ndarray:
        parts = [self.weights]
        for p in self.primitives:
            parts.append(p.params)
        return np.concatenate(parts)

    def set_parameters(self, vec):
        vec = np.asarray(vec, dtype=np.float64)
        n = len(self.primitives)
        self.weights = vec[:n].copy()
        off = n
        for p in self.primitives:
            p.params = vec[off:off + p.n_params].copy()
            off += p.n_params

    @property
    def is_energy_dependent(self):
        return any(
            getattr(p, "is_energy_dependent", False)
            for p in self.primitives
        )

    def __call__(self, phases, params=None, log10_ens=None):
        """Density at ``phases``.  A tensor of phases is evaluated on its
        device and gives a tensor (differentiable in ``params``, a tensor
        in ``get_parameters()`` layout); numpy phases are host data and
        give numpy, computed on the CPU.  ``log10_ens`` (per-photon
        log10(E/GeV)) feeds energy-dependent primitives
        (lceprimitives.LCEPrimitive); others ignore it."""
        if not isinstance(phases, torch.Tensor):
            u = None if log10_ens is None else host_tensor(log10_ens)
            return self(host_tensor(phases), params, u).numpy()
        n = len(self.primitives)
        if params is None:
            params = self.get_parameters()
        w = params[:n]
        out = 1.0 - w.sum()
        off = n
        for i, p in enumerate(self.primitives):
            kw = (
                {"log10_ens": log10_ens}
                if getattr(p, "is_energy_dependent", False) else {}
            )
            out = out + w[i] * p(
                phases, params=params[off:off + p.n_params], **kw
            )
            off += p.n_params
        return out

    def random(self, n, rng=None, log10_ens=None, *, device=None):
        """Draw ``n`` photon phases from the template by rejection; with
        ``log10_ens`` (length n) each photon is drawn from its own
        energy's density.

        ``rng``: a numpy Generator (default: a fresh one), whose draws are
        the reference's, call for call, and the phases come back as numpy;
        or a ``torch.Generator``, whose draws are made on its device, and
        the phases come back as a tensor there.  The densities are
        evaluated on ``device`` (None: the CUDA card; with a torch
        Generator, its device).  Both branches keep the envelope
        contract: a 1.1 margin over a grid-estimated maximum, and a
        rescale-and-restart when any computed density exceeds it."""
        use_torch = isinstance(rng, torch.Generator)
        if use_torch:
            dev = rng.device
        else:
            rng = rng or np.random.default_rng()
            dev = resolve_device(device)

        def uniform(size):
            if use_torch:
                return torch.rand(size, generator=rng, dtype=F64, device=dev)
            return torch.as_tensor(rng.uniform(size=size), device=dev)

        def finish(t):
            return t if use_torch else t.cpu().numpy()

        if log10_ens is not None:
            u = np.asarray(log10_ens, dtype=np.float64)
            if u.shape != (n,):
                raise ValueError("log10_ens must have length n")
        if n == 0:
            return finish(torch.empty(0, dtype=F64, device=dev))
        # candidate batches are padded to a 1024 multiple, as the
        # reference's (its numpy draws are matched call for call)
        n_pad = -(-n // 1024) * 1024
        params = torch.as_tensor(self.get_parameters(), device=dev)
        if log10_ens is None:
            fmax = 1.1 * float(torch.max(
                self(torch.linspace(0.0, 1.0, 2048, dtype=F64, device=dev),
                     params)))
            out, have = [], 0
            while have < n:
                cand = uniform(2 * n_pad)
                f = self(cand, params)
                f_hi = float(torch.max(f))
                if f_hi > fmax:
                    # a peak narrower than the 2048-point grid spacing
                    # slipped the estimate: raise and restart
                    fmax = 1.1 * f_hi
                    out, have = [], 0
                    continue
                keep = uniform(2 * n_pad) * fmax < f
                out.append(cand[keep])
                have += int(keep.sum())
            return finish(torch.cat(out)[:n])
        grid = torch.linspace(0.0, 1.0, 512, dtype=F64, device=dev)
        u_dev = torch.as_tensor(u, device=dev)
        # the density envelope at every photon's energy, in chunks of
        # (1024, 512): an interior-energy superposition of drifting peaks
        # can exceed any coarse-grid maximum
        chunk_maxes = [
            torch.max(self(grid[None, :], params,
                           log10_ens=u_dev[lo:lo + 1024, None]))
            for lo in range(0, n, 1024)
        ]
        fmax = 1.1 * float(torch.max(torch.stack(chunk_maxes)))
        u_pad = torch.cat([u_dev, u_dev[-1:].expand(n_pad - n)])
        phases = torch.empty(n, dtype=F64, device=dev)
        todo = torch.ones(n, dtype=torch.bool, device=dev)
        while bool(todo.any()):
            cand = uniform(n_pad)
            f = self(cand, params, log10_ens=u_pad)[:n]
            cand = cand[:n]
            # envelope check over ALL slots: a completed slot whose
            # fresh density exceeds fmax means its acceptance ran under a
            # too-low envelope: restart
            f_hi = float(torch.max(f))
            if f_hi > fmax:
                fmax = 1.1 * f_hi
                todo[:] = True
                continue
            keep = todo & (uniform(n) * fmax < f)
            phases = torch.where(keep, cand, phases)
            todo = todo & ~keep
        return finish(phases)

    def __repr__(self):
        inner = ", ".join(
            f"{w:.3f}*{p!r}" for w, p in zip(self.weights, self.primitives)
        )
        return f"LCTemplate({inner})"
