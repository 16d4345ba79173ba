"""Command-line tools (reference parity: src/pint/scripts/).

Each module has ``main(argv=None)`` with the reference's arguments plus
``--device`` (default ``cuda``: the CUDA card; ``cpu`` runs on the host
explicitly) and runs as ``python -m pint_tpu_torch.scripts.<tool>``.
"""

import contextlib as _contextlib
import signal as _signal

# die quietly when stdout is a closed pipe (e.g. `pintempo ... | head`)
with _contextlib.suppress(AttributeError, ValueError):
    _signal.signal(_signal.SIGPIPE, _signal.SIG_DFL)


def add_device_argument(ap):
    """The tools' ``--device``: where the model is evaluated and fitted."""
    ap.add_argument("--device", default="cuda",
                    help="torch device to evaluate and fit on (default "
                    "cuda; cpu runs on the host)")
