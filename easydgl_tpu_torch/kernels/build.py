"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes
``build/kernels/lib<name>-<digest>.so`` at the root of the checkout, compiled
for ``sm_90a`` at first use. The digest is of the source text and the shared
headers (``csrc/*.cuh``), so an edited source is rebuilt and a stale library
is never loaded. Nothing here runs at import time: this module imports on
machines without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """The library's path, keyed by a digest of the source and of every
    shared header in ``csrc/``."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Sequence[str]) -> Dict[str, float]:
    """Compiles every named source that has no current library, one nvcc
    process each, all started together. Returns the seconds each build took
    (0.0 where the library was already current); the compiler's resource
    report (-Xptxas -v) goes to ``build/kernels/<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       log, tmp, lib, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, log, tmp, lib, t0) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none
    if failed:
        logs = "\n".join((BUILD_DIR / f"{n}.log").read_text() for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
