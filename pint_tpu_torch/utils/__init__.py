"""Host-side helpers: sexagesimal angles, weighted statistics, DMX
summaries, content hashes for the ingest cache, and file-or-text opening.

Counterpart of ``pint_tpu/utils/``.
"""

from pint_tpu_torch.utils.angles import (  # noqa: F401
    format_angle_dms,
    format_angle_hms,
    parse_angle_dms,
    parse_angle_hms,
)
from pint_tpu_torch.utils.misc import (  # noqa: F401
    compute_hash,
    dmx_ranges_from_toas,
    dmxparse,
    lines_of,
    open_or_use,
    split_intervals,
    weighted_mean,
)
