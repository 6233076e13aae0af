"""Native (C++) host components, loaded via ctypes.

The compute path is JAX/XLA; these are the host-side pieces the reference
implements natively (BVH build, aggregate.rs) where tree quality directly
sets device traversal cost.  Compiled on first use with g++ into a shared
object (plain C ABI + ctypes) whose file name carries a hash of the
source, so a copied checkout never loads a library built from other
source.  It is built for the generic x86-64/aarch64 target, not for the
building machine's CPU, so it also runs on any other host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings

_DIR = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIB = None
_LIB_ERR = None


_SRC = os.path.join(_DIR, "sah.cpp")


def library_path(source: bytes) -> str:
    """Shared-object path for the given ``sah.cpp`` contents: the build
    is keyed on the source's hash, not on file times."""
    key = hashlib.sha256(source).hexdigest()[:16]
    return os.path.join(_DIR, f"_sah-{key}.so")


def _compile_and_load():
    global _LIB, _LIB_ERR
    with _LOCK:
        if _LIB is not None or _LIB_ERR is not None:
            return _LIB
        try:
            with open(_SRC, "rb") as f:
                so = library_path(f.read())
            if not os.path.exists(so):
                tmp = f"{so}.{os.getpid()}.tmp"
                subprocess.run(
                    [
                        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        _SRC, "-o", tmp,
                    ],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, so)
            _LIB = ctypes.CDLL(so)
            _LIB.build_sah_bvh.restype = ctypes.c_int64
        except Exception as e:  # pragma: no cover - depends on toolchain
            _LIB_ERR = e
            warnings.warn(
                f"native SAH builder unavailable ({e!r}); BVHs are built "
                "with the slower LBVH fallback",
                RuntimeWarning,
                stacklevel=3,
            )
        return _LIB


def sah_available() -> bool:
    return _compile_and_load() is not None


def build_sah_hierarchy(lo, hi, leaf_size: int = 8, nbins: int = 16):
    """Binned-SAH binary hierarchy with the same dict contract as
    ops/bvh.py::binary_hierarchy.  Returns None when the native builder
    is unavailable."""
    import numpy as np

    lib = _compile_and_load()
    if lib is None:
        return None
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    n = lo.shape[0]
    max_nodes = max(1, 2 * n - 1)
    order = np.empty(n, np.int32)
    node_l = np.empty(max_nodes, np.int64)
    node_r = np.empty(max_nodes, np.int64)
    left = np.empty(max_nodes, np.int64)
    right = np.empty(max_nodes, np.int64)
    is_leaf = np.empty(max_nodes, np.uint8)
    out_lo = np.empty((max_nodes, 3), np.float32)
    out_hi = np.empty((max_nodes, 3), np.float32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    n_nodes = lib.build_sah_bvh(
        ptr(lo, ctypes.c_float), ptr(hi, ctypes.c_float),
        ctypes.c_int64(n), ctypes.c_int(leaf_size), ctypes.c_int(nbins),
        ptr(order, ctypes.c_int32),
        ptr(node_l, ctypes.c_int64), ptr(node_r, ctypes.c_int64),
        ptr(left, ctypes.c_int64), ptr(right, ctypes.c_int64),
        ptr(is_leaf, ctypes.c_uint8),
        ptr(out_lo, ctypes.c_float), ptr(out_hi, ctypes.c_float),
    )
    if n_nodes <= 0:
        return None
    s = slice(0, n_nodes)
    return {
        "order": order,
        "node_l": node_l[s],
        "node_r": node_r[s],
        "left": left[s],
        "right": right[s],
        "is_leaf": is_leaf[s].astype(bool),
        "lo": out_lo[s],
        "hi": out_hi[s],
    }
