"""Builds of the port's native sources into shared libraries, at first use.

A library goes to ``build/repro_torch/`` at the repository root, named by
its source's stem and a hash of the source and the compiler's flags, so an
edited source or flag rebuilds.  The compiler's output is kept beside the
library as ``.log``.  A build writes a temporary file and renames it, so a
process that builds beside another never loads half a library.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def library_path(source: Path, flags: tuple) -> Path:
    """Where the library built from ``source`` with ``flags`` lives."""
    h = hashlib.sha256(source.read_bytes())
    h.update(repr(flags).encode())
    return BUILD_DIR / f"{source.stem}_{h.hexdigest()[:16]}.so"


def build(so: Path, compiler: str, flags: tuple, source: Path,
          error: "type[Exception]") -> Path:
    """Run ``compiler *flags -o so source``; raises ``error`` when the
    compiler cannot run or fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [compiler, *flags, "-o", str(tmp), str(source)]
    name = os.path.basename(compiler)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as err:
        raise error(f"cannot run {name} ({compiler}): {err}") from err
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise error(
            f"{name} failed ({proc.returncode}) building {source.name}:\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, so)  # atomic: a concurrent build never sees a half file
    return so
