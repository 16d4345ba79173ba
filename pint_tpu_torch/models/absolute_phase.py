"""Absolute phase anchor: the TZR reference arrival.

Counterpart of ``pint_tpu/models/absolute_phase.py::AbsPhase``:
TZRMJD/TZRSITE/TZRFRQ define a fiducial arrival at which the model phase
is zero.  A compiled model evaluates the phase of that one-row bundle
inside every phase-residual call (so inside ``jacfwd`` and the downhill
ladder's ``vmap``) and subtracts it with the carry-normalized
``Phase.__sub__`` (``timing_model.py::CompiledModel.absolute_phase``).

The TZR row is a one-row TOA table (``toas/bundle.py``) under the data
table's ``"tzr"`` key when a caller gives one (the reference's ingested
row when a state is carried across; ``simulation.py``'s synthetic
orbit), else :meth:`AbsPhase.tzr_table`: the TZR arrival ingested through
the model's own chain (clock files, EOP, ephemeris of the environment
in scope), as the reference does.  ``models/builder.py`` ingests it
eagerly when the model is built.
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

    def make_tzr_toas(self):
        """The one-TOA TOAs of the TZR arrival (host-side): TZRMJD in
        TDB at a barycentric site, else in UTC at TZRSITE."""
        from pint_tpu_torch.timebase.hostdd import HostDD
        from pint_tpu_torch.timebase.times import TimeArray
        from pint_tpu_torch.toas.toas import TOAs

        site = (self.params["TZRSITE"].value or "@").lower()
        frq = self.params["TZRFRQ"].value
        day, sec = self.params["TZRMJD"].value
        scale = "tdb" if site in BARYCENTRIC_SITES else "utc"
        t = TimeArray(np.array([int(day)]), HostDD([sec.hi], [sec.lo]),
                      scale)
        return TOAs(t, np.array([np.inf if frq is None else float(frq)]),
                    np.array([1.0]), [site], [dict()])

    def _tzr_config_key(self, model):
        day, sec = self.params["TZRMJD"].value
        ps = model.params.get("PLANET_SHAPIRO")
        top = model.top_params
        return (
            int(day), float(sec.to_float()),
            (self.params["TZRSITE"].value or "@").lower(),
            self.params["TZRFRQ"].value,
            top["EPHEM"].value if "EPHEM" in top else None,
            top["CLOCK"].value if "CLOCK" in top else None,
            bool(ps.value) if ps is not None else False,
        )

    def ingested_tzr_toas(self, model):
        """The TZR TOAs ingested through the model's chain, memoized by
        the TZR and chain configuration.  Built eagerly when the model is
        built (``models/builder.py``), so the clock/EOP/ephemeris
        environment in scope then is the one the reference arrival uses:
        a later compile in another environment would otherwise anchor the
        phase through a different chain."""
        from pint_tpu_torch.toas.ingest import ingest_for_model

        key = self._tzr_config_key(model)
        memo = getattr(self, "_tzr_memo", None)
        if memo is None or memo[0] != key:
            toas = self.make_tzr_toas()
            ingest_for_model(toas, model)
            self._tzr_memo = (key, toas)
        return self._tzr_memo[1]

    def tzr_table(self, model) -> dict:
        """The one-row host table of the TZR arrival, ingested through
        ``model``'s chain (:meth:`ingested_tzr_toas`)."""
        return self.ingested_tzr_toas(model).table()
