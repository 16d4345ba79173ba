"""Labeled-axis matrices: design/covariance with named axes.

Counterpart of ``pint_tpu/matrix.py`` (reference parity:
src/pint/pint_matrix.py: PintMatrix, DesignMatrix,
combine_design_matrices_by_quantity/param).  The stacking of the wideband
fitters' TOA and DM blocks happens inside ``jacfwd`` of the combined
residual vector (``fitting/wideband.py``), so this layer is the thin
inspection and export surface, host numpy: which column is which
parameter, which row block is which quantity.  ``from_fitter`` reads the
matrices off the device once.
"""

from __future__ import annotations

import numpy as np


class DesignMatrix:
    """matrix (n, p) + per-column parameter labels + per-row-block
    quantity labels [(name, start, stop)]."""

    def __init__(self, matrix, params, quantity_blocks=None):
        self.matrix = np.asarray(matrix)
        self.params = list(params)
        if self.matrix.shape[1] != len(self.params):
            raise ValueError(
                f"{self.matrix.shape[1]} columns vs "
                f"{len(self.params)} labels"
            )
        blocks = quantity_blocks or [("toa", 0, self.matrix.shape[0])]
        # normalized to tuples so equality checks are type-insensitive
        self.quantity_blocks = [
            (str(n), int(a), int(b)) for n, a, b in blocks
        ]

    @classmethod
    def from_fitter(cls, fitter) -> "DesignMatrix":
        """Labeled design matrix at the fitter's current state
        (wideband fitters contribute their stacked [TOA; DM] blocks)."""
        from pint_tpu_torch.fitting.base import design_with_offset

        cm = fitter.cm
        x = cm.x0()
        design = getattr(fitter, "_combined_design", None)
        M = (design(x) if design is not None
             else design_with_offset(cm, x)).detach().cpu().numpy()
        params = (
            ["Offset"] if fitter._noffset else []
        ) + list(cm.free_names)
        n = cm.bundle.ntoa
        blocks = [("toa", 0, n)]
        if M.shape[0] == 2 * n:  # wideband: [TOA; DM] stacking
            blocks.append(("dm", n, 2 * n))
        return cls(M, params, blocks)

    def column(self, param) -> np.ndarray:
        return self.matrix[:, self.params.index(param)]

    def block(self, quantity) -> np.ndarray:
        """All rows labeled `quantity` (stacked when a combine placed
        several same-named blocks)."""
        parts = [
            self.matrix[a:b] for name, a, b in self.quantity_blocks
            if name == quantity
        ]
        if not parts:
            raise KeyError(quantity)
        return parts[0] if len(parts) == 1 else np.vstack(parts)

    @property
    def shape(self):
        return self.matrix.shape

    def combine_by_quantity(self, other: "DesignMatrix") -> "DesignMatrix":
        """Stack ROW blocks of different quantities (e.g. TOA rows over
        DM rows); shared params align, disjoint params zero-fill
        (reference: pint_matrix.combine_design_matrices_by_quantity)."""
        params = list(self.params) + [
            p for p in other.params if p not in self.params
        ]
        n1, n2 = self.matrix.shape[0], other.matrix.shape[0]
        out = np.zeros((n1 + n2, len(params)))
        for j, p in enumerate(self.params):
            out[:n1, params.index(p)] = self.matrix[:, j]
        for j, p in enumerate(other.params):
            out[n1:, params.index(p)] = other.matrix[:, j]
        blocks = list(self.quantity_blocks) + [
            (name, a + n1, b + n1) for name, a, b in other.quantity_blocks
        ]
        return DesignMatrix(out, params, blocks)

    def combine_by_param(self, other: "DesignMatrix") -> "DesignMatrix":
        """Concatenate COLUMNS of additional parameters for the SAME
        rows (reference: combine_design_matrices_by_param): row counts
        and quantity blocks must match; duplicate params are an error.

        ROW stacking is combine_by_quantity (the reference's naming).
        """
        if self.matrix.shape[0] != other.matrix.shape[0]:
            raise ValueError(
                f"row mismatch: {self.matrix.shape[0]} vs "
                f"{other.matrix.shape[0]}"
            )
        if self.quantity_blocks != other.quantity_blocks:
            raise ValueError(
                "quantity blocks differ: "
                f"{self.quantity_blocks} vs {other.quantity_blocks}"
            )
        dup = set(self.params) & set(other.params)
        if dup:
            raise ValueError(f"duplicate params: {sorted(dup)}")
        return DesignMatrix(
            np.concatenate([self.matrix, other.matrix], axis=1),
            self.params + other.params,
            list(self.quantity_blocks),
        )

    def select_params(self, params) -> "DesignMatrix":
        """Column submatrix in the given parameter order."""
        idx = [self.params.index(p) for p in params]
        return DesignMatrix(
            self.matrix[:, idx], list(params), list(self.quantity_blocks)
        )

    def labels(self):
        """((row labels), (column labels)) — the reference's
        axis-label accessor shape."""
        return (
            tuple(self.quantity_blocks),
            tuple(self.params),
        )

    def __repr__(self):
        return (
            f"DesignMatrix{self.matrix.shape} params={self.params} "
            f"blocks={[b[0] for b in self.quantity_blocks]}"
        )


class CovarianceMatrix:
    """(p, p) parameter covariance with labels (reference:
    pint_matrix covariance makers)."""

    def __init__(self, matrix, params):
        self.matrix = np.asarray(matrix)
        self.params = list(params)

    @classmethod
    def from_fitter(cls, fitter) -> "CovarianceMatrix":
        if fitter.parameter_covariance_matrix is None:
            raise ValueError("fit first")
        return cls(
            fitter.parameter_covariance_matrix, fitter.cm.free_names
        )

    def sigma(self, param) -> float:
        i = self.params.index(param)
        return float(np.sqrt(self.matrix[i, i]))

    def correlation(self) -> np.ndarray:
        s = np.sqrt(np.diag(self.matrix))
        s = np.where(s == 0, 1.0, s)
        return self.matrix / np.outer(s, s)

    def submatrix(self, params) -> "CovarianceMatrix":
        """Parameter sub-block in the given order (reference:
        pint_matrix get_label_matrix)."""
        idx = [self.params.index(p) for p in params]
        return CovarianceMatrix(
            self.matrix[np.ix_(idx, idx)], list(params)
        )

    def combine_block_diag(self, other: "CovarianceMatrix"):
        """Block-diagonal combination over DISJOINT parameter sets
        (e.g. stacking per-pulsar covariances for PTA summaries)."""
        dup = set(self.params) & set(other.params)
        if dup:
            raise ValueError(f"duplicate params: {sorted(dup)}")
        p1, p2 = len(self.params), len(other.params)
        out = np.zeros((p1 + p2, p1 + p2))
        out[:p1, :p1] = self.matrix
        out[p1:, p1:] = other.matrix
        return CovarianceMatrix(out, self.params + other.params)

    def __repr__(self):
        return f"CovarianceMatrix({len(self.params)} params)"
