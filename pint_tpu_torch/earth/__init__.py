"""Earth orientation: precession, nutation, rotation, polar motion, EOP.

Counterpart of ``pint_tpu/earth/``: the Earth-orientation chain of the
host ingest (the pyerfa capabilities PINT reaches through astropy).
"""

from pint_tpu_torch.earth.rotation import (  # noqa: F401
    gcrs_posvel_from_itrf,
    itrf_to_gcrs_matrix,
)
