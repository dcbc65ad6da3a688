"""ctypes bindings for the native (C++) batch assembly (port of
``easydgl_tpu.data.native``).

The repo's ``native/batcher.cpp`` is the one source of both packages'
batchers, so that their contract stays one: row gather, per-row distinct
mask sampling (xoshiro256** streams seeded from (seed, epoch, batch, row))
and the mark-table gather, off the GIL. The library is built with ``g++``
at first use into ``build/native/`` of the checkout (``native/Makefile``'s
flags; nothing is written into ``native/``); ``CXX`` names another
compiler.

``available()`` is JAX's rule for the loader's ``use_native=None``: the
library that ``make -C native`` writes (``MAKE_PATH``, the file JAX's
``data/native.py`` probes) is there and loads, so both packages take the
same branch whatever the checkout holds. ``load_library(build=True)``
builds the port's own copy where it is missing and raises where it cannot
be built or loaded; the loader's ``use_native=True`` takes that path and
never falls back to NumPy. Both copies come from one source, so either
gives the same batches.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(ROOT, "native", "batcher.cpp")
LIB_DIR = os.path.join(ROOT, "build", "native")
LIB_NAME = "libeasydgl_data.so"
MAKE_PATH = os.path.join(ROOT, "native", LIB_NAME)
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
            "-Wall"]

_LIB = None


def library_path() -> str:
    return os.path.join(LIB_DIR, LIB_NAME)


def build_library() -> str:
    """Compile ``native/batcher.cpp`` into ``library_path()`` (written to a
    temporary name and renamed, so that ranks building at once never load
    a partial file); raises RuntimeError where the compiler fails."""
    os.makedirs(LIB_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=LIB_DIR)
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", tmp, SOURCE]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"native batcher: cannot run {cmd[0]}: {e}")
    if done.returncode:
        os.unlink(tmp)
        raise RuntimeError(f"native batcher: {' '.join(cmd)} failed:\n"
                           f"{done.stderr}")
    os.replace(tmp, library_path())
    return library_path()


def _bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    i64, i32p, i64p, f32p, i8p, u64 = (
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int8), ctypes.c_uint64)
    lib.gather_rows_i32.argtypes = [i32p, i64p, i64, i64, i32p]
    lib.gather_rows_f32.argtypes = [f32p, i64p, i64, i64, f32p]
    lib.masked_batch.argtypes = [i32p, i64, i64, i64, ctypes.c_int32, i64,
                                 u64, u64, u64, i32p, i32p, i32p]
    lib.mark_gather.argtypes = [i8p, i64, i64, i32p, i64, f32p]
    lib.abi_version.restype = ctypes.c_int
    if lib.abi_version() != 1:
        raise RuntimeError(f"native batcher: {path} has ABI "
                           f"{lib.abi_version()}, expected 1")
    return lib


def _load(path: str) -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = _bind(path)
    return _LIB


def load_library(build: bool = False) -> Optional[ctypes.CDLL]:
    """The bound library; None where it is not built (``build`` False), a
    RuntimeError where it cannot be built or loaded (``build`` True)."""
    if _LIB is not None:
        return _LIB
    path = library_path()
    if not os.path.exists(path):
        if not build:
            return None
        build_library()
    try:
        return _load(path)
    except OSError as e:
        if build:
            raise RuntimeError(f"native batcher: cannot load {path}: {e}")
        return None


def available() -> bool:
    """JAX's rule: ``MAKE_PATH`` is there and loads."""
    if not os.path.exists(MAKE_PATH):
        return False
    try:
        _load(MAKE_PATH)
    except OSError:
        return False
    return True


def _p(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def gather_rows(src: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """``src[indices]`` for int32 and float32 rows (NumPy for others)."""
    lib = load_library()
    idx = np.ascontiguousarray(indices, np.int64)
    src = np.ascontiguousarray(src)
    out = np.empty((len(idx),) + src.shape[1:], src.dtype)
    flat = int(np.prod(src.shape[1:]))
    if src.dtype == np.int32:
        lib.gather_rows_i32(_p(src, ctypes.c_int32), _p(idx, ctypes.c_int64),
                            len(idx), flat, _p(out, ctypes.c_int32))
    elif src.dtype == np.float32:
        lib.gather_rows_f32(_p(src, ctypes.c_float), _p(idx, ctypes.c_int64),
                            len(idx), flat, _p(out, ctypes.c_float))
    else:
        return src[idx]
    return out


def masked_batch(tokens: np.ndarray, masklen: int, mask_id: int,
                 ignore_head: int, seed: int, epoch: int, batch_idx: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(masked tokens, positions, labels) of the masked-family train
    protocols: ``masklen`` distinct positions a row in [ignore_head, L)."""
    lib = load_library()
    tokens = np.ascontiguousarray(tokens, np.int32)
    n, seqslen = tokens.shape
    masked = np.empty_like(tokens)
    positions = np.empty((n, masklen), np.int32)
    labels = np.empty((n, masklen), np.int32)
    lib.masked_batch(_p(tokens, ctypes.c_int32), n, seqslen, masklen,
                     mask_id, ignore_head, seed, epoch, batch_idx,
                     _p(masked, ctypes.c_int32),
                     _p(positions, ctypes.c_int32),
                     _p(labels, ctypes.c_int32))
    return masked, positions, labels


def mark_gather(table: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """float32 ``table[ids]``, ids outside the table taking row 0."""
    lib = load_library()
    table = np.ascontiguousarray(table, np.int8)
    ids = np.ascontiguousarray(ids, np.int32)
    out = np.empty(ids.shape + (table.shape[1],), np.float32)
    lib.mark_gather(_p(table, ctypes.c_int8), table.shape[0],
                    table.shape[1], _p(ids, ctypes.c_int32),
                    int(ids.size), _p(out, ctypes.c_float))
    return out
