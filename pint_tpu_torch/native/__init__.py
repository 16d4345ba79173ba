"""The host C++ MJD parser of the ingest: build at first use, ctypes
binding.

Counterpart of ``pint_tpu/native/__init__.py``.  ``pint_native.cpp`` is
compiled with the system g++ (``$CXX``) at first use into
``pint_tpu_torch/_build/`` as a shared library named after a hash of its
source, so an edited source never loads a stale build, and the build is
never committed.  ``available()`` says whether the native path is
active; without it (no compiler, or ``PINT_TPU_NO_NATIVE`` set) the
callers take the pure-Python parse.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import warnings
from pathlib import Path

import numpy as np

_SRC = Path(__file__).with_name("pint_native.cpp")
BUILD = Path(__file__).resolve().parent.parent / "_build"

_lib = None
_tried = False


def library_path() -> Path:
    """The build of ``pint_native.cpp``, named after its source's hash."""
    h = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD / f"libpint_native-{h}.so"


def _build(path: Path) -> bool:
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-shared", "-fPIC",
           "-std=c++17", str(_SRC), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        Path(tmp).unlink(missing_ok=True)
        warnings.warn(f"building pint_native failed ({e}); using the "
                      "pure-Python MJD parse")
        return False
    os.replace(tmp, path)  # atomic: a reader never sees half a file
    return True


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("PINT_TPU_NO_NATIVE"):
        return None
    path = library_path()
    try:
        if not path.exists() and not _build(path):
            return None
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        warnings.warn(f"loading pint_native failed ({e})")
        return None
    lib.parse_mjd_strings.restype = ctypes.c_int64
    lib.parse_mjd_strings.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.float64, flags="C"),
        np.ctypeslib.ndpointer(np.float64, flags="C"),
    ]
    lib.native_self_test.restype = ctypes.c_int64
    lib.native_self_test.argtypes = []
    if lib.native_self_test() != 0:
        warnings.warn("pint_native self-test failed; using the "
                      "pure-Python MJD parse")
        return None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def parse_mjd_strings(strings):
    """Batched exact decimal MJD parse (pulsar_mjd convention):
    -> (day int64 (n,), sec_hi (n,), sec_lo (n,)), or None when the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    try:
        enc = [s.strip().encode("ascii") for s in strings]
    except UnicodeEncodeError as e:
        raise ValueError(f"non-ASCII character in MJD string: {e}") from e
    n = len(enc)
    buf = b"".join(enc)
    lengths = np.array([len(e) for e in enc], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(
        np.int64
    )
    day = np.empty(n, dtype=np.int64)
    hi = np.empty(n, dtype=np.float64)
    lo = np.empty(n, dtype=np.float64)
    rc = lib.parse_mjd_strings(buf, offsets, lengths, n, day, hi, lo)
    if rc != 0:
        raise ValueError(
            f"bad MJD string at index {rc - 1}: {strings[rc - 1]!r}"
        )
    return day, hi, lo
