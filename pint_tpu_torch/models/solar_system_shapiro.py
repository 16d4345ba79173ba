"""Solar-system Shapiro delay (Sun, and the planets with PLANET_SHAPIRO).

Counterpart of ``pint_tpu/models/solar_system_shapiro.py``: delay
-(2 GM_b / c^3) ln((r - r.n) / AU) summed over bodies; the log's constant
offset is degenerate with overall phase.  At r == 0 (barycentric data)
the term is zero.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.constants import (
    AU_LIGHT_SEC,
    GM_JUPITER,
    GM_NEPTUNE,
    GM_SATURN,
    GM_SUN,
    GM_URANUS,
    GM_VENUS,
    SHAPIRO_T2,
)
from pint_tpu_torch.models.component import DelayComponent
from pint_tpu_torch.models.parameter import boolParameter

_PLANET_GM = {
    "venus": GM_VENUS,
    "jupiter": GM_JUPITER,
    "saturn": GM_SATURN,
    "uranus": GM_URANUS,
    "neptune": GM_NEPTUNE,
}


class SolarSystemShapiro(DelayComponent):
    register = True
    category = "solar_system_shapiro"

    def __init__(self):
        super().__init__()
        self.add_param(boolParameter("PLANET_SHAPIRO", value=False))
        self._astrometry_ref = None

    def setup(self, model):
        from pint_tpu_torch.models.astrometry import Astrometry

        self._astrometry_ref = None
        for c in model.components.values():
            if isinstance(c, Astrometry):
                self._astrometry_ref = c

    @staticmethod
    def _body_delay(gm, obs_body_pos_ls, psr_dir):
        r = torch.sqrt(torch.sum(obs_body_pos_ls**2, dim=-1))
        rn = torch.sum(obs_body_pos_ls * psr_dir, dim=-1)
        arg = torch.clamp_min((r - rn) / AU_LIGHT_SEC, 1e-30)
        return torch.where(
            r > 0, -(gm * SHAPIRO_T2) * torch.log(arg), torch.zeros_like(r)
        )

    def delay_term(self, pdict, bundle, acc_delay):
        if self._astrometry_ref is None:
            raise RuntimeError(
                "SolarSystemShapiro needs an astrometry component"
            )
        psr_dir = self._astrometry_ref.ssb_to_psr_xyz(pdict, bundle)
        d = self._body_delay(GM_SUN, bundle.obs_sun_pos_ls, psr_dir)
        if self.params["PLANET_SHAPIRO"].value:
            for body, gm in _PLANET_GM.items():
                if body in bundle.obs_planet_pos_ls:
                    d = d + self._body_delay(
                        gm, bundle.obs_planet_pos_ls[body], psr_dir
                    )
        return d
