"""rsoderh_raytracing_tpu_torch — the path tracer in PyTorch and CUDA.

A port of ``rsoderh_raytracing_tpu`` (JAX/Pallas, the reference) to
PyTorch on an NVIDIA H100. It covers the free-run wavefront main path:
scene and environment upload, the wavefront loop
(``render.wavefront.render_freerun`` / ``render_wavefront``) and its
kernels, written in CUDA C++ (``csrc/``) with a plain PyTorch twin each:
TRACE and SHADE for small scenes (``ops/cuda_wavefront.py``), and for
meshes past the unroll budget the chunked closest and occlusion sweeps
(``ops/cuda_intersect.py``) and BIG_SHADE.

This package imports ``torch`` and never ``jax``, nor anything of the
reference package: the host modules it needs (scene model, OBJ/TOML
loaders, camera, PNG writer, HDR I/O, alias tables) are its own copies.
Entry points put their tensors on the card (``device="cuda"``) unless
the caller asks for another device.
"""

__version__ = "0.2.0"

from rsoderh_raytracing_tpu_torch.scene.camera import Camera  # noqa: F401
from rsoderh_raytracing_tpu_torch.scene.toml_loader import load_scene  # noqa: F401
from rsoderh_raytracing_tpu_torch.utils.png import write_png  # noqa: F401
