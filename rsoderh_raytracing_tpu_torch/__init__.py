"""rsoderh_raytracing_tpu_torch — the path tracer in PyTorch and CUDA.

A port of ``rsoderh_raytracing_tpu`` (JAX/Pallas, the reference) to
PyTorch on an NVIDIA H100. It covers the renderer and its command line
(``render.renderer.Renderer``, ``python -m rsoderh_raytracing_tpu_torch``:
film, tonemap, PNG and .hdr output, checkpoints), the scan integrator
(``render.integrator.render_sample``), the wavefront loop
(``render.wavefront.render_freerun`` / ``render_wavefront``) with its
kernel loop and its composed body, bounce-synchronized rounds
(``render.wavefront.render_spp_sync``), the multi-device split
(``parallel.sharding``: ``make_mesh``, ``render_spp_sharded``,
``render_freerun_sharded``, ``ShardedRenderer``, ``dryrun``; the CLI's
``--devices``) and the terminal viewer (``view`` below,
``viewer.terminal.run_viewer``; the CLI's ``--view``). The kernels are
written in CUDA C++
(``csrc/``) with a plain PyTorch twin each: TRACE and SHADE for small
scenes, BIG_SHADE for meshes past the unroll budget
(``ops/cuda_wavefront.py``), and the sweeps CLOSEST, ANY, FUSED,
CHUNKED_CLOSEST and CHUNKED_ANY (``ops/cuda_intersect.py``).

This package imports ``torch`` and never ``jax``, nor anything of the
reference package: the host modules it needs (scene model, OBJ/TOML
loaders, camera, PNG writer, HDR I/O, alias tables) are its own copies.
Entry points put their tensors on the card (``device="cuda"``) unless
the caller asks for another device.
"""

__version__ = "0.3.0"

from rsoderh_raytracing_tpu_torch.scene.camera import Camera  # noqa: F401
from rsoderh_raytracing_tpu_torch.scene.toml_loader import load_scene  # noqa: F401
from rsoderh_raytracing_tpu_torch.utils.png import write_png  # noqa: F401

# The `render` subpackage shares its name with the function below. Import
# it now, so that Python binds the package attribute first and the `def`
# wins for good: otherwise the first deep import (which render() itself
# performs) rebinds the attribute to the module, and a second
# `render(...)` call fails with "'module' object is not callable".
import rsoderh_raytracing_tpu_torch.render  # noqa: E402,F401


def render(scene, width=512, height=512, spp=16, **kwargs):
    """One-shot render: the tonemapped (H, W, 3) image in linear [0, 1].
    Extra keywords go to render/renderer.py:Renderer (``device="cpu"``
    for the plain PyTorch path)."""
    from rsoderh_raytracing_tpu_torch.render.renderer import Renderer

    renderer = Renderer(scene, width=width, height=height, **kwargs)
    return renderer.render(spp=spp)


def view(
    scene,
    width: int = 256,
    height: int = 144,
    movement_keys: str = "wasdqe",
    other_keys: str = "cpe",
    **kwargs,
):
    """Open the interactive terminal viewer on `scene`. The key strings
    follow the reference renderer's layout config (6 movement + 3 other);
    extra keywords go to viewer/terminal.py:run_viewer (environments,
    max_bounces, max_fps, intersector, ``device="cpu"`` for the plain
    PyTorch path). Requires a TTY; returns the exit code."""
    from rsoderh_raytracing_tpu_torch.scene.camera import KeyboardLayout
    from rsoderh_raytracing_tpu_torch.viewer.terminal import run_viewer

    layout = KeyboardLayout.parse_config(movement_keys, other_keys)
    return run_viewer(scene, layout, width=width, height=height, **kwargs)
