"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``pint_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled, at first use, into ``pint_tpu_torch/_build/`` as a shared
library named after the source's content hash, so an edited source never
loads a stale build.  :func:`build_libraries` starts one nvcc per missing
library, all at once, and waits for them.  Nothing here runs at import.
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


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


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
