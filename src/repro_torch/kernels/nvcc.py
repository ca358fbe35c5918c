"""Build a CUDA source into a shared library with nvcc, at first use.

Each kernel package compiles its own ``csrc/*.cu`` for ``sm_90a`` into a
shared library with a plain C interface under its ``_build/`` directory,
named by the source's hash (so an edited source rebuilds), and binds it
with ``ctypes``.  Nothing here runs on import: CPU-only hosts import the
kernel modules and never call into them.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda; "
                       "the CUDA kernels cannot be built on this host")


def nvcc_command(source: Path, out: Path, nvcc: str = "nvcc") -> List[str]:
    """The build line: sm_90a, no fast-math (it flushes subnormal sums to
    zero and breaks bit-exactness against the plain versions)."""
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(out), str(source)]


def build(source: Path, build_dir: Path, stem: str) -> Path:
    """Compile ``source`` unless its library exists; returns its path.  The
    library is written to a temporary name and renamed, so a process never
    loads a half-written file from a concurrent build.  The compiler's
    register and stack report goes beside it, to :func:`report_path`."""
    digest = hashlib.sha1(source.read_bytes()).hexdigest()[:12]
    lib = build_dir / f"lib{stem}_{digest}.so"
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(source, Path(tmp), nvcc_path()),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        report_path(lib).write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def report_path(lib: Path) -> Path:
    """ptxas's report for the library ``lib`` (written when it was built)."""
    return lib.with_suffix(".ptxas.log")
