"""Logging setup with repeated-message dedup.

Counterpart of ``pint_tpu/logging.py`` (reference parity:
src/pint/logging.py, a loguru sink with dedup filters so repeated
per-TOA warnings print once): stdlib logging with the same surface,
``setup(level)`` for the scripts, a dedup filter keyed on (logger,
level, message prefix) whose memory is a bounded LRU and is reset
between fits (:func:`reset_dedup`), and :func:`structured`, which
emits records with a machine-readable field dict.  The port has no
flight recorder, so a passing record's ``span_id`` is None.
"""

from __future__ import annotations

import logging as _logging
import sys
from collections import OrderedDict

_LOGGER_NAME = "pint_tpu_torch"

#: the dedup memory's bound: one fit's distinct warnings never evict
#: each other, and a long-lived process does not grow with it
_DEDUP_MAXSIZE = 4096


class DedupFilter(_logging.Filter):
    """Pass each distinct message prefix once until :meth:`reset`."""

    def __init__(self, prefix_len: int = 60,
                 maxsize: int = _DEDUP_MAXSIZE):
        super().__init__()
        self.prefix_len = prefix_len
        self.maxsize = maxsize
        self._seen: OrderedDict = OrderedDict()

    def filter(self, record):
        key = (record.name, record.levelno,
               record.getMessage()[: self.prefix_len])
        if key in self._seen:
            self._seen.move_to_end(key)
            return False
        self._seen[key] = None
        while len(self._seen) > self.maxsize:
            self._seen.popitem(last=False)
        record.span_id = None
        return True

    def reset(self):
        """Forget all seen prefixes (between fits)."""
        self._seen.clear()


def setup(level: str = "INFO", dedup: bool = True, stream=None):
    """Configure the package's logger (idempotent); returns it."""
    logger = _logging.getLogger(_LOGGER_NAME)
    logger.setLevel(getattr(_logging, str(level).upper(), _logging.INFO))
    logger.handlers.clear()
    h = _logging.StreamHandler(stream or sys.stderr)
    h.setFormatter(_logging.Formatter(
        "%(asctime)s %(levelname)-7s %(name)s: %(message)s",
        datefmt="%H:%M:%S",
    ))
    if dedup:
        h.addFilter(DedupFilter())
    logger.addHandler(h)
    logger.propagate = False
    return logger


def get_logger(name: str = ""):
    return _logging.getLogger(
        f"{_LOGGER_NAME}.{name}" if name else _LOGGER_NAME
    )


def reset_dedup():
    """Reset every DedupFilter on the package's logger."""
    logger = _logging.getLogger(_LOGGER_NAME)
    for h in logger.handlers:
        for f in h.filters:
            if isinstance(f, DedupFilter):
                f.reset()


def structured(logger, level, msg, **fields):
    """Emit a record whose ``fields`` ride as the ``pint_tpu_fields``
    extra dict (machine-readable: a JSON formatter can serialize them)."""
    logger.log(level, msg, extra={"pint_tpu_fields": fields})
