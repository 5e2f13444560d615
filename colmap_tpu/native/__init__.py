"""Native C++ host runtime (compiled on demand, numpy fallbacks).

Reference host infrastructure counterpart: util/threading.h ThreadPool /
JobQueue, correspondence-graph compaction, brute-force descriptor matching
(feature/sift.cc:1003). The shared library is built from
native/src/runtime.cc with g++ at first use and cached; every entry point
has a pure-numpy fallback so the package works without a toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "src", "runtime.cc")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_lib() -> Optional[ctypes.CDLL]:
    global _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        cache_dir = os.environ.get(
            "COLMAP_TPU_CACHE",
            os.path.join(os.path.expanduser("~"), ".cache", "colmap_tpu"))
        os.makedirs(cache_dir, exist_ok=True)
        lib_path = os.path.join(cache_dir, f"runtime-{digest}.so")
        if not os.path.exists(lib_path):
            tmp = lib_path + f".tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                 "-march=native", "-o", tmp, _SRC],
                check=True, capture_output=True)
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(lib_path)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.ct_union_find.argtypes = [i64p, i64p, ctypes.c_int64,
                                      ctypes.c_int64, i64p]
        lib.ct_build_csr.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64,
                                     i64p, i64p]
        lib.ct_match_descriptors_u8.argtypes = [
            u8p, ctypes.c_int32, u8p, ctypes.c_int32, ctypes.c_float,
            ctypes.c_float, ctypes.c_int32, ctypes.c_int32, i32p]
        lib.ct_hamming_dist.argtypes = [u64p, ctypes.c_int64,
                                        ctypes.c_uint64, i32p]
        return lib
    except Exception:  # pragma: no cover - toolchain missing
        return None


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is None:
        _LIB = _build_lib()
    return _LIB


def available() -> bool:
    return _lib() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------------------
# union-find
# ---------------------------------------------------------------------------


def union_find(edges_a: np.ndarray, edges_b: np.ndarray, n_nodes: int
               ) -> np.ndarray:
    """Connected-component labels [n_nodes] from edge lists."""
    a = np.ascontiguousarray(edges_a, np.int64)
    b = np.ascontiguousarray(edges_b, np.int64)
    lib = _lib()
    if lib is not None:
        labels = np.empty(n_nodes, np.int64)
        lib.ct_union_find(_ptr(a, ctypes.c_int64), _ptr(b, ctypes.c_int64),
                          len(a), n_nodes, _ptr(labels, ctypes.c_int64))
        return labels
    # numpy fallback
    parent = np.arange(n_nodes, dtype=np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for x, y in zip(a, b):
        rx, ry = find(x), find(y)
        if rx != ry:
            parent[max(rx, ry)] = min(rx, ry)
    return np.array([find(i) for i in range(n_nodes)], np.int64)


def build_csr(keys: np.ndarray, n_bins: int):
    """Group indices by key; returns (offsets [n_bins+1], order [n])."""
    k = np.ascontiguousarray(keys, np.int64)
    lib = _lib()
    if lib is not None:
        offsets = np.empty(n_bins + 1, np.int64)
        order = np.empty(len(k), np.int64)
        lib.ct_build_csr(_ptr(k, ctypes.c_int64), len(k), n_bins,
                         _ptr(offsets, ctypes.c_int64),
                         _ptr(order, ctypes.c_int64))
        return offsets, order
    order = np.argsort(k, kind="stable")
    offsets = np.searchsorted(k[order], np.arange(n_bins + 1))
    return offsets.astype(np.int64), order.astype(np.int64)


def match_descriptors_u8(d1: np.ndarray, d2: np.ndarray,
                         max_ratio: float = 0.8, max_distance: float = 0.7,
                         cross_check: bool = True,
                         num_threads: int = -1) -> np.ndarray:
    """CPU brute-force SIFT matching; returns (n1,) int32 indices (-1 = none).

    Semantics mirror the device matcher (features/matching.py) and the
    reference FindBestMatchesBruteForce.
    """
    d1 = np.ascontiguousarray(d1, np.uint8)
    d2 = np.ascontiguousarray(d2, np.uint8)
    lib = _lib()
    if lib is not None:
        out = np.empty(len(d1), np.int32)
        lib.ct_match_descriptors_u8(
            _ptr(d1, ctypes.c_uint8), len(d1), _ptr(d2, ctypes.c_uint8),
            len(d2), max_ratio, max_distance, int(cross_check),
            num_threads, _ptr(out, ctypes.c_int32))
        return out
    # numpy fallback
    f1 = d1.astype(np.float32)
    f2 = d2.astype(np.float32)
    f1 /= np.maximum(np.linalg.norm(f1, axis=1, keepdims=True), 1e-9)
    f2 /= np.maximum(np.linalg.norm(f2, axis=1, keepdims=True), 1e-9)
    sims = f1 @ f2.T
    idx = np.argsort(-sims, axis=1)[:, :2]
    best = idx[:, 0]
    d_best = np.arccos(np.clip(sims[np.arange(len(d1)), best], -1, 1))
    d_second = np.arccos(np.clip(sims[np.arange(len(d1)), idx[:, 1]], -1, 1))
    ok = (d_best <= max_distance) & (d_best < max_ratio * d_second)
    if cross_check:
        rev = np.argmax(sims, axis=0)
        ok &= rev[best] == np.arange(len(d1))
    return np.where(ok, best, -1).astype(np.int32)


def hamming_distances(signatures: np.ndarray, query: int) -> np.ndarray:
    s = np.ascontiguousarray(signatures, np.uint64)
    lib = _lib()
    if lib is not None:
        out = np.empty(len(s), np.int32)
        lib.ct_hamming_dist(_ptr(s, ctypes.c_uint64), len(s),
                            ctypes.c_uint64(int(query) & (2**64 - 1)),
                            _ptr(out, ctypes.c_int32))
        return out
    x = s ^ np.uint64(query)
    out = np.zeros(len(s), np.int32)
    for _ in range(64):
        out += (x & np.uint64(1)).astype(np.int32)
        x >>= np.uint64(1)
    return out
