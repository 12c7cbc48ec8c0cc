"""Build the package's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C launch function and compiles on its
own into ``build/kernels/<name>-<hash>.so`` at the repository root, for
``sm_90a`` (Hopper).  The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is never served from a
stale library.  A build writes to a temporary
name and renames it into place, so concurrent processes may race safely.
Nothing here runs on the CPU path: the wrappers call :func:`load` only for a
CUDA tensor, and it raises if ``nvcc`` is missing or a build fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

__all__ = ["SOURCES", "BUILD_DIR", "DTYPE_CODE", "nvcc", "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("rmsnorm", "decode_attention", "gemv", "gemv_tiles", "empty")
# <repo>/src/repro_torch/kernels/build.py -> <repo>/build/kernels (gitignored)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
CUDA_HOME = Path("/usr/local/cuda")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dtype codes of the C launch functions (kFloat32, kBFloat16 in csrc/common.cuh)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under the toolkit's usual home."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = CUDA_HOME / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under /usr/local/cuda/bin; the CUDA "
        "kernels can only be built on a machine with the CUDA toolkit"
    )


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source not built yet, one ``nvcc`` each, in parallel.

    Returns ``{name: ptxas log}`` (registers, shared memory and spills of
    each kernel, from ``-Xptxas -v``), read back from the log kept beside a
    library that was already built.
    """
    names = list(names)
    unknown = sorted(set(names) - set(SOURCES))
    if unknown:
        raise ValueError(f"unknown kernel sources {unknown}; known: {SOURCES}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = _lib_path(name)
        if lib.is_file():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    logs = {}
    for name in names:
        log = _lib_path(name).with_suffix(".log")
        logs[name] = log.read_text() if log.is_file() else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it at first use."""
    if name not in _LOADED:
        build([name])
        _LOADED[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LOADED[name]
