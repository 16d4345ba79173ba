"""Interactive fitting layer (pintk replacement).

Counterpart of ``pint_tpu/pintk.py`` (reference parity:
src/pint/pintk/): the Tk GUI is out of scope; its testable core is here,
``Pulsar`` (pintk/pulsar.py), the stateful session the GUI drives: load
par/tim, fit on the session's ``device`` (None: the CUDA card),
delete/restore TOAs, add jumps, random-model draws, undo, and the
paredit/timedit editing surface (``get_par_text``/``edit_par`` and
``get_tim_text``/``edit_tim``), which re-ingests when an edit changes
the ingest options (EPHEM, CLOCK, PLANET_SHAPIRO).  ``plk()`` is a
minimal matplotlib front end; matplotlib is imported there only.
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.fitting import auto_fitter
from pint_tpu_torch.models.builder import get_model
from pint_tpu_torch.residuals import Residuals


class Pulsar:
    """Stateful par/tim session driving fits and TOA edits
    (reference: pintk/pulsar.py::Pulsar)."""

    def __init__(self, parfile, timfile=None, toas=None, *, device=None):
        self.parfile = parfile
        self.device = device
        self.model = get_model(parfile)
        self._par_backup = self.model.as_parfile()
        if toas is not None:
            self.all_toas = toas
        else:
            from pint_tpu_torch.toas.cache import get_TOAs

            self.all_toas = get_TOAs(timfile, model=self.model)
        self.deleted = np.zeros(len(self.all_toas), dtype=bool)
        self.fitter = None
        self._fit_history: list[str] = []

    # -- selection -------------------------------------------------------
    @property
    def selected_toas(self):
        return self.all_toas[~self.deleted]

    def delete_toas(self, indices):
        self.deleted[np.asarray(indices, dtype=int)] = True

    def restore_toas(self, indices=None):
        if indices is None:
            self.deleted[:] = False
        else:
            self.deleted[np.asarray(indices, dtype=int)] = False

    # -- fitting ---------------------------------------------------------
    def residuals(self) -> Residuals:
        return Residuals(self.selected_toas, self.model, device=self.device)

    def fit(self, **kw) -> float:
        """Fit the non-deleted TOAs; history enables undo.  The undo
        entry is recorded only after the fit succeeds, so a raising fit
        leaves the history consistent."""
        pre_fit = self.model.as_parfile()
        kw.setdefault("device", self.device)
        fitter = auto_fitter(self.selected_toas, self.model, **kw)
        chi2 = fitter.fit_toas()
        self._fit_history.append(pre_fit)
        self.fitter = fitter
        return chi2

    def undo_fit(self):
        """Undo the last fit OR par edit.  If the undone edit had
        changed an ingest-relevant card, the TOAs are re-ingested
        under the restored model so model and geometry columns never
        diverge."""
        if not self._fit_history:
            raise ValueError("nothing to undo")
        old = self.model
        self.model = get_model(self._fit_history.pop())
        self.fitter = None
        if any(
            self._card(old, c) != self._card(self.model, c)
            for c in self._INGEST_CARDS
        ):
            from pint_tpu_torch.toas.ingest import ingest_for_model

            ingest_for_model(self.all_toas, self.model)

    def reset_model(self):
        self.model = get_model(self._par_backup)
        self.fitter = None
        self._fit_history.clear()

    # -- par/tim editing (paredit/timedit capability) --------------------
    _INGEST_CARDS = ("EPHEM", "CLOCK", "PLANET_SHAPIRO")

    @staticmethod
    def _card(model, name):
        p = model.top_params.get(name) or model.params.get(name)
        return None if p is None else p.value

    def get_par_text(self) -> str:
        """Current model as par-file text (the paredit buffer)."""
        return self.model.as_parfile()

    def edit_par(self, text: str):
        """Apply edited par text: rebuild the model (undo-able like a
        fit) and recompute residuals.  If the edit changes an
        ingest-relevant card (EPHEM/CLOCK/PLANET_SHAPIRO) the TOAs are
        re-ingested under the new options — matching get_TOAs'
        model-driven chain (reference: pintk/paredit.py apply)."""
        from pint_tpu_torch.toas.ingest import ingest_for_model

        old_model = self.model
        pre = old_model.as_parfile()
        new_model = get_model(text)
        reingest = any(
            self._card(old_model, c) != self._card(new_model, c)
            for c in self._INGEST_CARDS
        )
        self.model = new_model
        self._fit_history.append(pre)
        self.fitter = None
        if reingest:
            ingest_for_model(self.all_toas, new_model)
        return self.model

    def get_tim_text(self) -> str:
        """Current (non-deleted flags preserved) TOAs as tim text."""
        import io as _io

        from pint_tpu_torch.io.tim import write_tim_file

        buf = _io.StringIO()
        write_tim_file(buf, self.all_toas)
        return buf.getvalue()

    def edit_tim(self, text: str):
        """Apply edited tim text: reparse + re-ingest under the
        current model; the deletion mask resets (TOA identity is not
        preserved across an edit), matching pintk/timedit.py apply."""
        import io as _io

        from pint_tpu_torch.io.tim import get_TOAs_from_tim
        from pint_tpu_torch.toas.ingest import ingest_for_model

        toas = get_TOAs_from_tim(_io.StringIO(text))
        ingest_for_model(toas, self.model)
        self.all_toas = toas
        self.deleted = np.zeros(len(toas), dtype=bool)
        self.fitter = None
        return toas

    # -- jumps -----------------------------------------------------------
    def add_jump(self, indices) -> str:
        """JUMP the given TOA indices via a -gui_jump flag selection
        (reference: pintk jump workflow)."""
        from pint_tpu_torch.models.jump import PhaseJump

        comp = self.model.components.get("PhaseJump")
        if comp is None:
            comp = PhaseJump()
            self.model.add_component(comp)
        n_existing = len(comp.jump_params)
        tag = str(n_existing + 1)
        for i in np.asarray(indices):
            self.all_toas.flags[int(i)]["gui_jump"] = tag
        p = comp.mask_families()["JUMP"](n_existing + 1)
        p.set_from_tokens(["-gui_jump", tag, "0", "1"])
        self.model.setup()
        return p.name

    # -- random models ---------------------------------------------------
    def random_models(self, n_models: int = 20):
        if self.fitter is None:
            raise ValueError("fit first")
        from pint_tpu_torch.simulation import calculate_random_models

        return calculate_random_models(self.fitter, n_models=n_models)

    def write_fit_par(self, path):
        with open(path, "w") as f:
            f.write(self.model.as_parfile())

    def __repr__(self):
        return (
            f"Pulsar({self.model.name!r}, {len(self.all_toas)} TOAs, "
            f"{int(self.deleted.sum())} deleted)"
        )


def plk(parfile, timfile, block: bool = True, *, device=None):
    """Minimal interactive residual viewer/fitter (matplotlib):
    'f' = fit, 'u' = undo fit, 'd' = delete nearest TOA, 'r' = restore
    all, 'q' = close.  Returns the Pulsar session."""
    import matplotlib.pyplot as plt

    psr = Pulsar(parfile, timfile, device=device)
    fig, ax = plt.subplots(figsize=(9, 5))

    def redraw():
        from pint_tpu_torch.plot_utils import plot_residuals

        ax.clear()
        r = psr.residuals()
        plot_residuals(psr.selected_toas, r, ax=ax)
        ax.set_title(
            f"{psr.model.name}  chi2={r.chi2:.2f} dof={r.dof}"
        )
        fig.canvas.draw_idle()

    def on_key(event):
        try:
            if event.key == "f":
                psr.fit()
                redraw()
            elif event.key == "u":
                psr.undo_fit()
                redraw()
            elif event.key == "r":
                psr.restore_toas()
                redraw()
            elif event.key == "d" and event.xdata is not None:
                live = np.flatnonzero(~psr.deleted)
                mjd = psr.all_toas.mjd_float()[live]
                psr.delete_toas(
                    [live[np.argmin(np.abs(mjd - event.xdata))]]
                )
                redraw()
            elif event.key == "q":
                plt.close(fig)
        except Exception as e:  # viewer must survive bad keypresses
            ax.set_title(f"{type(e).__name__}: {e}")
            fig.canvas.draw_idle()

    fig.canvas.mpl_connect("key_press_event", on_key)
    redraw()
    if block:
        plt.show()
    return psr
