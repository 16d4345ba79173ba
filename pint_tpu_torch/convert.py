"""Build the port's model and bundle from a plain dict of numpy state.

This is how a state computed elsewhere — for instance by the JAX
reference package, exported by a test harness — is carried across, so
that both packages compute on byte-identical inputs.  The dict holds:

- ``"bundle"``: a TOA table (``toas/bundle.py``): ``tdb_day``,
  ``tdb_sec_hi``, ``tdb_sec_lo``, ``freq_mhz``, ``error_us``,
  ``ssb_obs_pos_ls``, ``ssb_obs_vel_c``, ``obs_sun_pos_ls``,
  ``obs_planet_pos_ls`` (dict), ``pulse_number``, ``padd`` and ``masks``
  (every mask selection and noise basis, e.g. ``"EFAC1"``,
  ``"pl_red_noise:F"``);
- ``"ref"``: internal reference values by parameter name — a float, a
  ``(hi, lo)`` double-double, or a ``(day, hi, lo)`` epoch; bools and
  strings pass as they are;
- ``"free_names"``: the free parameters in x order;
- ``"components"``: a list of ``{"name": <class name>, ...settings}``,
  with ``"masks"`` (mask parameter names: EFAC, JUMP, ...) and
  ``"params"`` (every parameter name, in the component's order, so that
  indexed families such as the DMX ranges, BT pieces and FB terms are
  made in the same order as where the state came from), and ``TNREDC``
  / ``PLANET_SHAPIRO`` carried through ``ref``.  Per-range masks
  (``DMX_####``, ``BTX_####``) ride in the bundle's ``masks``.
"""

from __future__ import annotations

from pint_tpu_torch.device import resolve_device
from pint_tpu_torch.models.builder import COMPONENTS
from pint_tpu_torch.models.timing_model import TimingModel, reference_values
from pint_tpu_torch.timebase.hostdd import HostDD
from pint_tpu_torch.toas.bundle import make_bundle


def _internal(v):
    if isinstance(v, (tuple, list)) and len(v) == 2:
        return HostDD(float(v[0]), float(v[1]))
    if isinstance(v, (tuple, list)) and len(v) == 3:
        return int(v[0]), HostDD(float(v[1]), float(v[2]))
    if isinstance(v, (bool, str)):
        return v
    return float(v)


def state_from_numpy(state: dict, device=None):
    """-> (model, bundle, ref): the port's TimingModel with the state's
    internal values set bit for bit, the TOABundle on ``device``, and the
    reference-value dict the compiled model will anchor x = 0 to."""
    device = resolve_device(device)
    comps = []
    for spec in state["components"]:
        name = spec["name"]
        if name not in COMPONENTS:
            raise NotImplementedError(
                f"component {name} is outside the ported slice; ROADMAP A6"
            )
        c = COMPONENTS[name]()
        for mname in spec.get("masks", ()):
            fams = c.mask_families()
            prefix = mname.rstrip("0123456789")
            fams[prefix](int(mname[len(prefix):]))
        for pname in spec.get("params", ()):
            if pname not in c.params:
                c.ensure_param(pname)
        comps.append(c)
    model = TimingModel(components=comps)
    params = model.params
    free = list(state["free_names"])
    for n, v in state["ref"].items():
        if n not in params:
            raise NotImplementedError(
                f"parameter {n} is outside the ported slice; ROADMAP A6"
            )
        params[n]._internal = _internal(v)
        params[n].frozen = n not in free
    model.setup()
    if model.free_params != free:
        raise ValueError(
            f"free-parameter order {model.free_params} differs from the "
            f"state's {free}"
        )
    table = state["bundle"]
    bundle = make_bundle(table, model._build_masks(table), device)
    return model, bundle, reference_values(model)
