"""ctypes binding of the native graph core, `native/graphcore.cpp`
(counterpart of `spgemm_gnn_tpu/graphs/native.py`).

At first use the source is compiled with the host's `g++ -O3 -std=c++17
-shared -fPIC` into `build/native/libgraphcore_<hash>.so` at the
repository root (the hash covers the source and the flags, so an edited
source builds anew) and loaded with ctypes. The library checked in beside
the source is never loaded: it was built with `-march=native` for another
machine.

Two entry points are bound: `gc_build_csr` (the CSR sort, `build_csr`) and
`gc_labelprop` (label propagation, `labelprop`). The library's tile and
stream planners (`gc_plan_*`, `gc_stream_*`) fill the JAX package's
TilePlan and StreamPlan arrays, which the port's plans do not hold, so
they stay unbound.

This is host code: where no compiler is present, or the build fails, every
entry point returns None and its caller takes its numpy path, which gives
the same arrays bit for bit. Which path is taken is logged once at INFO
level (`available()` says it too).
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "graphcore.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_log = logging.getLogger(__name__)
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | bool | None = None   # None: not tried; False: absent

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def library_path() -> Path:
    """Where the library of the current source and flags is built."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libgraphcore_{h.hexdigest()[:16]}.so"


def _build(target: Path) -> str | None:
    """Compile the source into `target`; the reason on failure."""
    cxx = shutil.which("g++")
    if cxx is None:
        return "no g++ on PATH"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"g++ failed: {exc}"
    if proc.returncode != 0:
        return f"g++ exit {proc.returncode}: {proc.stderr.strip()[-400:]}"
    os.replace(tmp, target)   # atomic against a parallel build
    return None


def _load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if not SOURCE.exists():
            _log.info("native graph core: %s not found; numpy host builds",
                      SOURCE)
            _LIB = False
            return _LIB
        target = library_path()
        reason = None if target.exists() else _build(target)
        if reason is not None:
            _log.info("native graph core unavailable (%s); numpy host "
                      "builds", reason)
            _LIB = False
            return _LIB
        lib = ctypes.CDLL(str(target))
        lib.gc_build_csr.restype = ctypes.c_int
        lib.gc_build_csr.argtypes = [ctypes.c_int64, _i64p, _i64p,
                                     ctypes.c_int64, _i32p, _i32p, _i32p]
        lib.gc_labelprop.restype = ctypes.c_int64
        lib.gc_labelprop.argtypes = [_i64p, _i32p, ctypes.c_int64,
                                     ctypes.c_int64, _i64p]
        _log.info("native graph core: %s", target)
        _LIB = lib
        return _LIB


def available() -> bool:
    """True where the library is built and loaded (the host builds take
    it), False where they take their numpy paths."""
    return bool(_load())


def build_csr(src: np.ndarray, dst: np.ndarray, num_nodes: int
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """The CSR of the edges src[e] → dst[e] sorted by (dst, src): (indptr
    int32 [N+1], indices int32 [E], edge_dst int32 [E]), or None without
    the library."""
    lib = _load()
    if not lib:
        return None
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    n_edges = src.shape[0]
    indptr = np.empty(num_nodes + 1, np.int32)
    indices = np.empty(n_edges, np.int32)
    edge_dst = np.empty(n_edges, np.int32)
    if lib.gc_build_csr(n_edges, src, dst, num_nodes, indptr, indices,
                        edge_dst) != 0:
        return None
    return indptr, indices, edge_dst


def labelprop(indptr: np.ndarray, indices: np.ndarray, num_nodes: int,
              iters: int = 8) -> np.ndarray | None:
    """Label propagation's int64 labels (graphs/relabel.py::
    _labelprop_labels' numpy sweeps bit for bit), or None without the
    library."""
    lib = _load()
    if not lib:
        return None
    labels = np.arange(num_nodes, dtype=np.int64)
    if lib.gc_labelprop(np.ascontiguousarray(indptr, np.int64),
                        np.ascontiguousarray(indices, np.int32), num_nodes,
                        iters, labels) < 0:
        return None
    return labels
