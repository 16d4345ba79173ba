"""Global clock-correction repository management.

Counterpart of ``pint_tpu/observatory/global_clock.py`` (PINT's
global_clock_corrections.py auto-downloads site clock chains from the IPTA
pulsar-clock-corrections repository into the astropy cache and warns on
staleness.  Offline-first design here: the same repository LAYOUT
(index.txt + tempo2-format .clk files) is consumed from a local
checkout/mirror pointed at by $PINT_TPU_CLOCK_DIR; this module reads
the index, reports staleness, and installs files into the active clock
directory.
"""

from __future__ import annotations

import os
import shutil
import warnings
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class IndexEntry:
    name: str
    update_mjd: float
    valid_end_mjd: float


class Index:
    """Parsed index.txt: '<file> <update MJD> <valid-end MJD> ...' rows
    (comment lines ignored; extra columns tolerated)."""

    def __init__(self, entries):
        self.files = {e.name: e for e in entries}

    @classmethod
    def from_file(cls, path) -> "Index":
        entries = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) < 2:
                    continue
                try:
                    update = float(parts[1])
                    valid = float(parts[2]) if len(parts) > 2 else np.inf
                except ValueError:
                    continue
                entries.append(IndexEntry(parts[0], update, valid))
        return cls(entries)

    def stale_files(self, now_mjd: float, max_age_days: float = 120.0):
        return sorted(
            name for name, e in self.files.items()
            if now_mjd - e.update_mjd > max_age_days
            or e.valid_end_mjd < now_mjd
        )


def update_clock_files(
    repo_dir, clock_dir=None, now_mjd: float = None,
    max_age_days: float = 120.0,
):
    """Install .clk files from a local pulsar-clock-corrections mirror
    into the active clock directory; warn about stale entries.

    Returns the list of installed file names.
    """
    repo = Path(repo_dir)
    env_dir = os.environ.get("PINT_TPU_CLOCK_DIR")
    if clock_dir is None and env_dir is None:
        warnings.warn(
            "installing clock files into the current directory, but "
            "$PINT_TPU_CLOCK_DIR is unset — the ingest clock chain "
            "only reads that directory, so set it (or pass clock_dir) "
            "for the files to take effect"
        )
    clock_dir = Path(clock_dir or env_dir or ".")
    clock_dir.mkdir(parents=True, exist_ok=True)
    index_path = repo / "index.txt"
    index = None
    if index_path.exists():
        index = Index.from_file(index_path)
        if now_mjd is not None:
            stale = index.stale_files(now_mjd, max_age_days)
            if stale:
                warnings.warn(
                    f"clock files stale per index.txt: {stale} "
                    f"(older than {max_age_days} d or past validity)"
                )
    installed = []
    seen: dict = {}
    for src in sorted(repo.rglob("*.clk")):
        if src.name in seen:
            warnings.warn(
                f"duplicate clock file name {src.name!r}: keeping "
                f"{seen[src.name]}, skipping {src.relative_to(repo)}"
            )
            continue
        seen[src.name] = src.relative_to(repo)
        dst = clock_dir / src.name
        if (
            not dst.exists()
            or src.stat().st_mtime > dst.stat().st_mtime
        ):
            shutil.copy2(src, dst)
        installed.append(src.name)
    if not installed:
        warnings.warn(f"no .clk files found under {repo}")
    return installed
