"""Content hashing and file-or-object opening for the ingest layer.

Counterpart of ``pint_tpu/utils/misc.py``'s ``compute_hash``,
``open_or_use`` and ``lines_of``.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import os


def compute_hash(*items) -> str:
    """Stable content hash for cache keys: file paths hash their bytes;
    other values hash their repr."""
    h = hashlib.sha256()
    for it in items:
        if isinstance(it, (str, os.PathLike)) and os.path.isfile(it):
            with open(it, "rb") as f:
                for block in iter(lambda: f.read(1 << 20), b""):
                    h.update(block)
        else:
            h.update(repr(it).encode())
        h.update(b"\x00")
    return h.hexdigest()


def open_or_use(obj, mode: str = "r"):
    """Context manager: open(path), or pass a file object through."""
    if isinstance(obj, (str, os.PathLike)):
        return open(obj, mode)
    return contextlib.nullcontext(obj)


def lines_of(obj):
    """Iterate the lines of a path, a file object or a multi-line str."""
    if isinstance(obj, str) and "\n" in obj:
        return io.StringIO(obj)
    return open_or_use(obj)
