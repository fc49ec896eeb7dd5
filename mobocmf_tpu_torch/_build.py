"""Build the port's CUDA sources (csrc/*.cu) and load them with ctypes.

Each source is compiled by nvcc for sm_90a into a shared library with a
plain C interface, under build/kernels/ beside the package (a directory
that .gitignore lists). A library is built at first use and rebuilt when
its source is newer. `build()` starts one nvcc per source, all at once. A
variant built with preprocessor defines (the profiling build of K1) gets a
library of its own.
Nothing here runs at import time: the CPU tests import every module on a
machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("chol", "fused_svgp")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on the GPU machine")


def lib_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    suffix = "".join(f"-{d.lower()}" for d in defines)
    return BUILD_DIR / f"lib{name}{suffix}.so"


def _stale(name: str, defines: Tuple[str, ...] = ()) -> bool:
    """The library is missing or older than its source or a shared header."""
    lib = lib_path(name, defines)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def build(names: Optional[Iterable[str]] = None, defines: Tuple[str, ...] = ()) -> Dict[str, str]:
    """Compile the named sources (default: all stale ones), one nvcc process
    per source, started together, with -D for each of `defines`. Returns
    each build's compiler output (register and shared-memory use from
    -Xptxas=-v); raises on failure."""
    names = [n for n in (SOURCES if names is None else names) if _stale(n, defines)]
    if not names:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        tmp = BUILD_DIR / f"{lib_path(name, defines).name}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, lib_path(name, defines))
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu (built with `defines`), built
    first if needed."""
    key = lib_path(name, defines).name
    lib = _loaded.get(key)
    if lib is None:
        build([name], defines)
        lib = ctypes.CDLL(str(lib_path(name, defines)))
        _loaded[key] = lib
    return lib
