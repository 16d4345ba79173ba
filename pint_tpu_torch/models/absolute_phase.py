"""Absolute phase anchor: the TZR reference arrival.

Counterpart of ``pint_tpu/models/absolute_phase.py::AbsPhase``:
TZRMJD/TZRSITE/TZRFRQ define a fiducial arrival at which the model phase
is zero.  A compiled model evaluates the phase of that one-row bundle
inside every phase-residual call (so inside ``jacfwd`` and the downhill
ladder's ``vmap``) and subtracts it with the carry-normalized
``Phase.__sub__`` (``timing_model.py::CompiledModel.absolute_phase``).

The TZR row is a one-row TOA table (``toas/bundle.py``) under the data
table's ``"tzr"`` key: the reference's ingested row when a state is
carried across, or, for a barycentric site ('@'), :meth:`tzr_table`
here, with zero geometry as the reference's barycentric ingest leaves it
(``simulation.py`` puts its synthetic orbit on it).  Other sites need the
port's own ingest (ROADMAP A11).
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.models.component import Component
from pint_tpu_torch.models.parameter import (
    MJDParameter,
    floatParameter,
    strParameter,
)

#: TZRSITE names of the solar-system barycentre (TZRMJD is then TDB)
BARYCENTRIC_SITES = ("@", "bat", "ssb", "barycenter")


class AbsPhase(Component):
    category = "absolute_phase"

    def __init__(self):
        super().__init__()
        self.add_param(MJDParameter("TZRMJD"))
        self.add_param(strParameter("TZRSITE", value="@"))
        self.add_param(floatParameter("TZRFRQ", units="MHz"))

    def validate(self, model):
        self.require("TZRMJD")

    @property
    def anchored(self) -> bool:
        return self.params["TZRMJD"].value is not None

    def tzr_table(self) -> dict:
        """The one-row host table of a barycentric TZR arrival: TZRMJD as
        TDB, TZRFRQ (infinite when unset), zero geometry."""
        site = (self.params["TZRSITE"].value or "@").lower()
        if site not in BARYCENTRIC_SITES:
            raise NotImplementedError(
                f"TZRSITE {site!r}: a topocentric TZR arrival needs the "
                "port's own ingest (ROADMAP A11); carry the reference's "
                "ingested TZR row across instead")
        day, sec = self.params["TZRMJD"].value
        frq = self.params["TZRFRQ"].value
        return {
            "tdb_day": np.array([float(day)]),
            "tdb_sec_hi": np.array([float(sec.hi)]),
            "tdb_sec_lo": np.array([float(sec.lo)]),
            "freq_mhz": np.array([np.inf if frq is None else float(frq)]),
            "error_us": np.array([1.0]),
            "ssb_obs_pos_ls": np.zeros((1, 3)),
            "obs_sun_pos_ls": np.zeros((1, 3)),
            "pulse_number": np.array([np.nan]),
            "padd": np.zeros(1),
            "flags": [{}],
        }
