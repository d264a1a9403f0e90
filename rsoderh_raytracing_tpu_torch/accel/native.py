"""ctypes bindings to the port's native host builders (csrc/*.cpp).

Counterpart of rsoderh_raytracing_tpu/accel/native.py, over the port's
own copies of the C++ sources: ``csrc/bvh_build.cpp`` (the SAH BVH
builder) here, ``csrc/alias_table.cpp`` in env/alias_table.py. Each is
compiled at first use with the reference's g++ flags into
``build/native/`` at the root of the checkout, under a name made from a
hash of the source and the flags, through a temporary file and
``os.replace``: processes building at once never load a file that
another is still writing. Every entry point returns None when g++ or the
library is unavailable, so callers fall back to their numpy builders.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
BVH_SRC = os.path.join(_PKG, "csrc", "bvh_build.cpp")
# The reference's flags (rsoderh_raytracing_tpu/accel/native.py), so the
# builds stay bitwise equal to the reference's.
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_bvh_lib = None
_bvh_failed = False


def host_library(src: str) -> str:
    """Path of the shared library built from the C++ source `src`
    (compiled now if this source and these flags have not been);
    raises OSError or CalledProcessError when g++ fails."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    lib_path = os.path.join(NATIVE_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(lib_path):
        os.makedirs(NATIVE_DIR, exist_ok=True)
        tmp = f"{lib_path}.tmp{os.getpid()}"
        subprocess.run(["g++", *GXX_FLAGS, src, "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, lib_path)
    return lib_path


def _load_bvh():
    global _bvh_lib, _bvh_failed
    with _lock:
        if _bvh_lib is not None or _bvh_failed:
            return _bvh_lib
        try:
            lib = ctypes.CDLL(host_library(BVH_SRC))
        except (OSError, subprocess.CalledProcessError) as err:
            logging.getLogger(__name__).warning(
                "native BVH builder unavailable (%s); using numpy", err)
            _bvh_failed = True
            return None
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.build_bvh_sah.restype = ctypes.c_int64
        lib.build_bvh_sah.argtypes = [
            f32p, f32p, ctypes.c_int64,
            f32p, f32p, i32p, i32p, i32p, i32p,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _bvh_lib = lib
        return lib


def available() -> bool:
    return _load_bvh() is not None


def build_bvh_native(mins: np.ndarray, maxs: np.ndarray):
    """Returns (nodes_min, nodes_max, payload, count, axis, order, depth)
    or None. Same flat layout as the numpy builder."""
    lib = _load_bvh()
    if lib is None:
        return None
    mins = np.ascontiguousarray(mins, np.float32)
    maxs = np.ascontiguousarray(maxs, np.float32)
    n = len(mins)
    cap = max(1, 2 * n - 1)
    nodes_min = np.empty((cap, 3), np.float32)
    nodes_max = np.empty((cap, 3), np.float32)
    payload = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    axis = np.empty(cap, np.int32)
    order = np.empty(n, np.int32)
    depth = ctypes.c_int32(0)
    k = lib.build_bvh_sah(
        mins, maxs, n, nodes_min, nodes_max, payload, count, axis, order,
        ctypes.byref(depth),
    )
    if k < 0:
        return None
    return (
        nodes_min[:k].copy(),
        nodes_max[:k].copy(),
        payload[:k].copy(),
        count[:k].copy(),
        axis[:k].copy(),
        order,
        int(depth.value),
    )
