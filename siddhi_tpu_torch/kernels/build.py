"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``build/lib<name>-<tag>.so`` next to this file (the directory is
git-ignored), at first use, for ``sm_90a``; ``<tag>`` hashes the source
and ``NVCC_FLAGS``, so a change to either builds a new library.  The
build directory must be writable: the port runs from a checkout or from
an install its user can write to.  The sources expose a plain C
interface (no PyTorch headers), which keeps a build to seconds.
``build_all`` starts one ``nvcc`` per source at once.

``PROTOTYPES`` gives the ctypes prototype of every ``extern "C"``
function of every source; ``load`` sets them once, when it loads the
library, and ``entry`` hands a wrapper the function object, so no call
pays for them.  Every pointer and the stream are ``c_void_p``: a plain
int argument would be cut to 32 bits.

Nothing here runs when the module is imported: the CPU tests import
every module of the port on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from ctypes import c_int, c_void_p
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# source -> {function: (restype, argtypes)}
PROTOTYPES = {
    "probe": {
        "probe_add_one": (c_int, (c_void_p, c_void_p, c_int, c_void_p)),
    },
    "dense_step": {
        "dense_step_launch": (c_int, (c_void_p,) * 9 + (c_int,) * 5
                              + (c_void_p,)),
    },
    "dense_batch": {
        "dense_batch_plan": (c_int, (c_void_p,) + (c_int,) * 4),
        "dense_batch_launch": (c_int, (c_void_p,) * 12 + (c_int,) * 2
                               + (c_void_p,)),
    },
    "scan_chain": {
        "scan_chain_launch": (c_int, (c_void_p,) * 7 + (c_int,) * 3
                              + (c_void_p,)),
    },
    "bank_scatter": {
        "bank_scatter_slices": (c_int, (c_int,)),
        "bank_scatter_scratch": (c_int, (c_int, c_int)),
        "bank_scatter_launch": (c_int, (c_void_p,) * 5),
    },
}
SOURCES = tuple(PROTOTYPES)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOADED: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[Tuple[str, str], Callable] = {}
# ptxas register / spill report of each build in this process
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return nvcc


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = SOURCES) -> List[str]:
    """Compile every stale library among ``names`` in parallel; return
    the names that were built.  Raises with nvcc's output on failure."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return []
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        BUILD_LOGS[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built first if needed, with
    the prototypes of ``PROTOTYPES[name]`` set on its functions."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (restype, argtypes) in PROTOTYPES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LOADED[name] = lib
    return lib


def entry(name: str, fn: str) -> Callable:
    """The ctypes function ``fn`` of ``lib<name>.so``, prototype set."""
    f = _ENTRIES.get((name, fn))
    if f is None:
        f = _ENTRIES[(name, fn)] = getattr(load(name), fn)
    return f
