"""ctypes bindings for the native preprocessing kernels.

Compiled lazily with the system C++ compiler on first use and cached next to
the source, under a name keyed by a hash of the source and the compile
flags: a library built from another revision (or copied from another host
with other flags) is never loaded, it is rebuilt. The flags target the
generic x86-64/aarch64 baseline, so the library runs on any host of the
same architecture. Every entry point has a numpy fallback in
score_tpu.data.prep_common, so a missing toolchain only costs speed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "prep_kernels.cc")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> str:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(_HERE, f"_prep_kernels-{h.hexdigest()[:16]}.so")


def _compile(out: str) -> Optional[str]:
    for cc in ("c++", "g++", "clang++"):
        try:
            # build to a temp file then atomic-rename (parallel test safety)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_HERE)
            os.close(fd)
            subprocess.run([cc, *_FLAGS, _SRC, "-o", tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)
            return out
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired):
            try:
                os.unlink(tmp)
            except OSError:
                pass
            continue
    return None


def load() -> Optional[ctypes.CDLL]:
    """The compiled library, or None if no toolchain is available."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = lib_path()
        if not os.path.exists(path):
            path = _compile(path)
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.build_side.restype = ctypes.c_int
        lib.build_side.argtypes = [
            i32p, i32p, i32p,                      # node, nbr, slot
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64,                       # seed
            i32p, i32p, i64p, i32p]                # dense, cnt, indptr, indices
        lib.bucket_slots.restype = None
        lib.bucket_slots.argtypes = [
            i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, i32p]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_side_native(node: np.ndarray, nbr: np.ndarray, slot: np.ndarray,
                      num_nodes: int, num_slots: int, fanout: int,
                      seed: int):
    """Native adjacency build; returns (dense, cnt, indptr, indices) with the
    schema.py layout, or None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    n = np.int64(node.size)
    node = np.ascontiguousarray(node, np.int32)
    nbr = np.ascontiguousarray(nbr, np.int32)
    slot = np.ascontiguousarray(slot, np.int32)
    dense = np.zeros((num_slots, num_nodes + 1, fanout), np.int32)
    cnt = np.zeros((num_slots, num_nodes + 1), np.int32)
    indptr = np.zeros((num_slots, num_nodes + 2), np.int64)
    indices = np.zeros(int(n), np.int32)
    rc = lib.build_side(
        _ptr(node, ctypes.c_int32), _ptr(nbr, ctypes.c_int32),
        _ptr(slot, ctypes.c_int32), n, np.int64(num_nodes),
        np.int64(num_slots), np.int64(fanout), np.uint64(seed),
        _ptr(dense, ctypes.c_int32), _ptr(cnt, ctypes.c_int32),
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32))
    if rc != 0:
        raise ValueError(f"build_side failed with code {rc} "
                         "(id out of range?)")
    return dense, cnt, indptr, indices


def bucket_slots_native(ts: np.ndarray, num_slots: int):
    lib = load()
    if lib is None:
        return None
    ts = np.ascontiguousarray(ts, np.int64)
    out = np.empty(ts.size, np.int32)
    lib.bucket_slots(_ptr(ts, ctypes.c_int64), np.int64(ts.size),
                     np.int64(num_slots), np.int64(ts.min()),
                     np.int64(ts.max()), _ptr(out, ctypes.c_int32))
    return out
