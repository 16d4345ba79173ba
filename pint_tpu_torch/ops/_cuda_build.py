"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``pint_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled, at first use, into ``pint_tpu_torch/_build/`` as a shared
library named after a hash of the source and of every header in
``csrc/`` (``*.cuh``), so an edited source or header never loads a stale
build.  :func:`build_libraries` starts one nvcc per missing
library, all at once, and waits for them; :func:`c_entry` binds a
library's C entry.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_loaded: dict[str, ctypes.CDLL] = {}
_entries: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the toolkit")


def library_path(name: str) -> Path:
    """The build of ``csrc/<name>.cu``, named after the hash of the source
    and of every ``csrc/*.cuh`` (any of them may be included)."""
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_libraries(names) -> dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process each, all started together.  Returns name -> library path;
    the ptxas report of each build is kept beside it as ``.log``."""
    BUILD.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = []
    for name, path in paths.items():
        if path.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for name, path, tmp, proc in procs:
        out, _ = proc.communicate()
        path.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            Path(tmp).unlink(missing_ok=True)
        else:
            os.replace(tmp, path)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_libraries([name])[name]
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib


def c_entry(name: str, argtypes):
    """The C entry ``<name>_launch`` of ``csrc/<name>.cu`` with its ctypes
    signature (every pointer and the stream as c_void_p, ints as c_int),
    returning the cudaError code; built at first use."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(load_library(name), f"{name}_launch")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


#: (wrapper, attribute) of every launch count of the kernels' wrappers.
#: A wrapper adds one where it launches its kernel; a CUDA graph's replay
#: adds what its capture recorded (runtime/graphs.py)
LAUNCH_COUNTERS: list = []


def count_launches(wrapper, *attrs):
    """Give a kernel wrapper launch counts from 0 and register them."""
    for attr in attrs:
        setattr(wrapper, attr, 0)
        LAUNCH_COUNTERS.append((wrapper, attr))


#: the reference kernels' precision rungs (their MXU pass ladder)
PRECISIONS = ("highest", "high", "default")


def check_precision(name: str, precision: str):
    """The reference kernels take ``precision='highest'|'high'|'default'``,
    the bf16 pass ladder of the TPU's matrix unit.  The port's kernels and
    plain versions take the three names and compute the same values for
    each: exact products of the f32 operands summed in f64, at least as
    accurate as the reference's ``'highest'``.  Any other name raises."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"{name}: unknown precision={precision!r}; expected one of "
            f"{PRECISIONS}"
        )
