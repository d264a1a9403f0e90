"""Build and bind the CUDA kernels in ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` (``wavefront.cu``:
TRACE, SHADE, ENV_DRAW, BIG_SHADE; ``chunked.cu``: CHUNKED_CLOSEST, CHUNKED_ANY;
``sweep.cu``: CLOSEST, ANY, FUSED; ``bvh.cu``: BVH_CLOSEST, BVH_ANY), one
process a source, all started
together, and links them into one
shared library with a plain C interface, written under
``build/kernels/`` at the root of the checkout (named by a hash of the
sources, so an edit rebuilds). It is loaded with ctypes; every pointer and the stream are
``c_void_p``. Each C launcher returns ``cudaGetLastError()`` and the
wrappers raise when it is not 0.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3 -fmad=false``, no
``--use_fast_math``: division, sqrt and the transcendentals stay IEEE /
libdevice-accurate, and no multiply-add is contracted, so the kernels
round like their unfused plain PyTorch twins. Measured on an H100 (700 W)
at 4.2M lanes: with contraction TRACE takes 1.63 ms instead of 1.81, but
its bounce sample then leaves the plain version's rtol 1e-4 on 0.56% of
the lanes (near-specular GGX amplifies the rounding), so the flag stays
(PERF.md).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from rsoderh_raytracing_tpu_torch import tracing

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None
BUILD_INFO: dict = {}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> str:
    """Compile the kernels with NVCC_FLAGS if needed; returns the library
    path. Fills BUILD_INFO with the seconds taken and the ptxas report."""
    digest = hashlib.sha256()
    for src in _sources():
        with open(src, "rb") as f:
            digest.update(os.path.basename(src).encode() + f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    tag = digest.hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"libwavefront_{tag}.so")
    if os.path.exists(lib_path):
        BUILD_INFO.update(seconds=0.0, cached=True, path=lib_path)
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [s for s in _sources() if s.endswith(".cu")]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    link_flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    suffix = f"{tag}.{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{suffix}.o") for src in cu]
    start = time.perf_counter()
    procs = [
        subprocess.Popen([_nvcc(), *compile_flags, "-c", "-o", obj, src],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, obj in zip(cu, objs)
    ]
    outs = [proc.communicate() for proc in procs]
    log = "".join(out + err for out, err in outs)
    failed = [src for src, proc in zip(cu, procs) if proc.returncode != 0]
    tmp = lib_path + f".tmp{os.getpid()}"
    if not failed:
        link = subprocess.run([_nvcc(), *link_flags, "-o", tmp, *objs],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed = ["link"]
    seconds = time.perf_counter() - start
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    with open(os.path.join(BUILD_DIR, "nvcc.log"), "w") as f:
        f.write(log)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log[-4000:]}")
    os.replace(tmp, lib_path)
    BUILD_INFO.update(
        seconds=seconds, cached=False, path=lib_path,
        ptxas=[ln for ln in log.splitlines() if "registers" in ln or "spill" in ln
               or "Compiling entry function" in ln],
    )
    return lib_path


def load():
    """Build (if needed) and bind the library."""
    lib = ctypes.CDLL(build())
    vp, i = ctypes.c_void_p, ctypes.c_int
    u = ctypes.c_uint32
    i64 = ctypes.c_int64
    signatures = {
        "rt_trace_launch": [vp, vp, i, i, i, i, i, i, vp, vp, i, i, vp],
        "rt_shade_launch": [vp, i, i, i, i, i, i, u, u, u, u, u, vp, i64, vp],
        "rt_big_shade_launch": [vp, vp, vp, i, i, i, vp, i, i, i, i, i, i, u, u, u, u, u, vp, i64, vp],
        "rt_env_draw_launch": [vp, vp, i, i, i, vp],
        "rt_chunked_closest_launch": [vp, vp, i, i, i, vp, vp, i, i, vp, vp, vp, i, i, vp],
        "rt_chunked_any_launch": [vp, vp, i, i, i, vp, vp, i, i, vp, i, i, vp],
        "rt_chunked_shared_bytes": [i, i],
        "rt_chunked_batch": [],
        "rt_sweep_max_table_bytes": [],
        "rt_closest_launch": [vp, vp, i, i, i, i, i, i, i, i, i, vp],
        "rt_any_launch": [vp, vp, i, i, i, i, i, i, i, i, vp],
        "rt_fused_launch": [vp, vp, i, i, i, i, i, i, vp],
        "rt_bvh_closest_launch": [vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, vp, vp, i, vp],
        "rt_bvh_any_launch": [vp, vp, vp, vp, i, i, vp, i, vp],
        "rt_bvh_fallback_shared_bytes": [i, i],
        "rt_bvh_fallback_max_rows_bytes": [],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.restype = i
        fn.argtypes = argtypes
    lib.rt_error_string.restype = ctypes.c_char_p
    lib.rt_error_string.argtypes = [i]
    return lib


def library():
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            with tracing.span("kernels.load"):
                _lib = load()
    return _lib


def error_string(code: int) -> str:
    return f"{code} ({library().rt_error_string(code).decode()})"
