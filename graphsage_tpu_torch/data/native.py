"""The C++ host builder: padded adjacency and random walks.

``csrc/graph_builder.cpp`` (a byte-identical copy of the JAX package's
``native/graph_builder.cpp``) compiles with g++ at first use into
``build/native/libgraph_builder.so`` at the root of the checkout (listed
in ``.gitignore``) and loads with ctypes. The library is rebuilt when it
is missing or older than its source, and written under a temporary name
and renamed, so concurrent processes never load a half-written file.
Nothing is built when the module is imported.

Both functions return None when the library cannot be built or loaded;
the callers (``data/adjacency.py``, ``data/walks.py``) then take their
NumPy paths, and the first failure is reported once on stderr. Each
function adds one to its ``calls`` where the library ran.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "graph_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-pthread", "-shared")

_lock = threading.Lock()
_state: dict = {}   # "lib": the loaded library or None, once tried


def _build() -> Path:
    lib = BUILD_DIR / "libgraph_builder.so"
    if lib.exists() and lib.stat().st_mtime >= SOURCE.stat().st_mtime:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
         str(SOURCE)],
        capture_output=True, text=True, check=False, timeout=300,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE} (exit "
                           f"{proc.returncode}): {proc.stderr.strip()}")
    os.replace(tmp, lib)
    return lib


def load():
    """The loaded library, built if needed, or None if that failed (said
    once on stderr)."""
    with _lock:
        if "lib" in _state:
            return _state["lib"]
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            print(f"graphsage_tpu_torch: the C++ host builder is "
                  f"unavailable ({exc}); the NumPy paths run instead",
                  file=sys.stderr)
            _state["lib"] = None
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.pad_adjacency.restype = None
        lib.pad_adjacency.argtypes = [
            i32p,              # flat neighbor pool
            i64p,              # offsets [n+1]
            ctypes.c_int64,    # n
            ctypes.c_int32,    # max_degree
            ctypes.c_uint64,   # seed
            i32p,              # out adj [(n+1)*max_degree]
        ]
        lib.random_walks.restype = ctypes.c_int64
        lib.random_walks.argtypes = [
            i32p,              # flat neighbor pool
            i64p,              # offsets [n+1]
            ctypes.c_int64,    # n
            i32p,              # start nodes
            ctypes.c_int64,    # number of start nodes
            ctypes.c_int32,    # num_walks
            ctypes.c_int32,    # walk_len
            ctypes.c_uint64,   # seed
            i32p,              # out pairs [capacity*2]
            ctypes.c_int64,    # capacity (pairs)
        ]
        _state["lib"] = lib
        return lib


def available() -> bool:
    return load() is not None


def _flatten(neighbors: list) -> tuple[np.ndarray, np.ndarray]:
    """(pool, offsets): the neighbor lists end to end, int32, and where
    each starts, int64 [n+1]."""
    lens = np.fromiter(map(len, neighbors), dtype=np.int64,
                       count=len(neighbors))
    offsets = np.zeros(len(neighbors) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    if offsets[-1] == 0:
        return np.zeros(0, dtype=np.int32), offsets
    return np.concatenate(neighbors).astype(np.int32, copy=False), offsets


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def native_pad_adjacency(neighbors: list, n: int, max_degree: int,
                         seed: int) -> np.ndarray | None:
    """[n+1, max_degree] int32 padded adjacency, or None without the
    library."""
    lib = load()
    if lib is None:
        return None
    pool, offsets = _flatten(neighbors)
    pool = np.ascontiguousarray(pool)
    out = np.empty(((n + 1) * max_degree,), dtype=np.int32)
    lib.pad_adjacency(_ptr(pool, ctypes.c_int32),
                      _ptr(offsets, ctypes.c_int64), n, max_degree, seed,
                      _ptr(out, ctypes.c_int32))
    native_pad_adjacency.calls += 1
    return out.reshape(n + 1, max_degree)


def native_random_walks(neighbors: list, nodes: np.ndarray, num_walks: int,
                        walk_len: int, seed: int) -> np.ndarray | None:
    """[W, 2] int32 (start, visited) pairs, or None without the
    library."""
    lib = load()
    if lib is None:
        return None
    pool, offsets = _flatten(neighbors)
    pool = np.ascontiguousarray(pool)
    nodes = np.ascontiguousarray(nodes, dtype=np.int32)
    cap = len(nodes) * num_walks * walk_len
    out = np.empty((cap * 2,), dtype=np.int32)
    count = lib.random_walks(
        _ptr(pool, ctypes.c_int32), _ptr(offsets, ctypes.c_int64),
        len(neighbors), _ptr(nodes, ctypes.c_int32), len(nodes), num_walks,
        walk_len, seed, _ptr(out, ctypes.c_int32), cap)
    native_random_walks.calls += 1
    return out[: count * 2].reshape(-1, 2).copy()


native_pad_adjacency.calls = 0
native_random_walks.calls = 0
