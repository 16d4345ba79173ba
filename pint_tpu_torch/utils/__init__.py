"""Host-side helpers of the ingest layer: sexagesimal angles, content
hashes for the ingest cache, and file-or-text opening.

Counterpart of ``pint_tpu/utils/``, cut to what the port's ingest reads.
"""

from pint_tpu_torch.utils.angles import (  # noqa: F401
    format_angle_dms,
    format_angle_hms,
    parse_angle_dms,
    parse_angle_hms,
)
from pint_tpu_torch.utils.misc import (  # noqa: F401
    compute_hash,
    lines_of,
    open_or_use,
)
