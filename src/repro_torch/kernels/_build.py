"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (``_build/lib<name>.so``, listed in .gitignore),
loaded with ``ctypes`` at first use.  Nothing is compiled or loaded at
import time: the CPU tests import every module on a machine with no nvcc.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3``, and never
``--use_fast_math`` — the kernels must round exactly like their plain
PyTorch versions (IEEE division, rintf, no contracted dequant).

Every C entry point returns ``cudaGetLastError()`` right after its launch;
:func:`call` raises on a non-zero code, so a refused launch (too many
threads, too much shared memory) never passes silently.

``LAUNCHES`` counts kernel launches by name: each wrapper calls
:func:`count` exactly where it launches, so a run can show that its path
went through the kernels.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}

P = ctypes.c_void_p
I64 = ctypes.c_longlong
I32 = ctypes.c_int


def count(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset_launches() -> None:
    LAUNCHES.clear()


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda/bin, "
                           "PATH): the CUDA kernels cannot be built here")
    return found


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named sources (default: all) that are missing or older
    than their source or a shared header (``csrc/*.cuh``), one ``nvcc`` per
    source, all started together.
    Returns each compiled source's ptxas report; raises on any failure."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    headers = max((h.stat().st_mtime for h in CSRC.glob("*.cuh")),
                  default=0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, out = srcs[name], _lib_path(name)
        if (out.exists() and out.stat().st_mtime
                >= max(src.stat().st_mtime, headers)):
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)     # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.
    ``signatures``: C function name -> argtypes (all return int)."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = I32
        lib.kernel_error_string.argtypes = [I32]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def call(lib: ctypes.CDLL, fn: str, *args) -> None:
    """Launch through C entry point ``fn`` and raise on its CUDA error."""
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{fn}: CUDA error {rc} ({msg})")
