"""rsoderh_raytracing_tpu_torch — the path tracer in PyTorch and CUDA.

A port of ``rsoderh_raytracing_tpu`` (JAX/Pallas, the reference) to
PyTorch on an NVIDIA H100. It covers the free-run wavefront main path:
scene and environment upload, the wavefront loop
(``render.wavefront.render_freerun`` / ``render_wavefront``), and its two
kernels, TRACE and SHADE, written in CUDA C++ (``csrc/``) with a plain
PyTorch twin each (``ops/cuda_wavefront.py``).

This package imports ``torch`` and never ``jax``. The host scene code
(TOML/OBJ loading, camera, BVH builder, PNG writer) is reused by import
from the reference package, whose host modules import no jax either.
"""

__version__ = "0.1.0"

import os as _os

# The reference package's __init__ imports jax when RT_DEBUG_NANS=1 (its
# jax_debug_nans switch). That switch means nothing here, so it is hidden
# while the reference package is first imported.
_debug_nans = _os.environ.pop("RT_DEBUG_NANS", None)
try:
    from rsoderh_raytracing_tpu.scene.camera import Camera  # noqa: F401
    from rsoderh_raytracing_tpu.scene.toml_loader import load_scene  # noqa: F401
    from rsoderh_raytracing_tpu.utils.png import write_png  # noqa: F401
finally:
    if _debug_nans is not None:
        _os.environ["RT_DEBUG_NANS"] = _debug_nans
