"""Builds the port's CUDA sources into shared libraries on first use.

Each kernel is a ``.cu`` file under its package's ``csrc/`` with a plain C
interface. ``nvcc`` compiles it for Hopper (``sm_90a``) into
``build/repro_torch/<name>-<hash>.so`` at the root of the checkout, where
the hash covers the source and the flags, so an edited source rebuilds. The
library is loaded with ``ctypes``; the wrappers pass every pointer and the
stream as ``c_void_p``.

Nothing here runs at import: ``import repro_torch`` works without ``nvcc``,
and a build starts only when a CUDA tensor first reaches a kernel (or when
``build_all`` is called). A build that fails raises with the compiler's
output; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent        # src/repro_torch
BUILD_DIR = _PKG.parent.parent / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# kernel name -> source, relative to the package
SOURCES: Dict[str, str] = {
    "mule_agg": "kernels/mule_agg/csrc/mule_agg.cu",
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME/bin``; raises if absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "cannot build the CUDA kernels: nvcc is neither on PATH nor under "
        f"{home}/bin (set CUDA_HOME to the CUDA toolkit)")


def library_path(name: str) -> Path:
    src = _PKG / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, all in parallel.

    Returns ``{name: compiler output}`` for the kernels built by this call
    (``-Xptxas=-v`` makes it list registers and shared memory per kernel).
    """
    todo = [n for n in (SOURCES if names is None else names)
            if not library_path(n).is_file()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(_PKG / SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))   # atomic: no half-written .so
        else:
            os.unlink(tmp)
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if it is missing."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
