"""Integrator constants and the camera tensors (port of the parts of
rsoderh_raytracing_tpu/render/integrator.py the wavefront uses)."""

from __future__ import annotations

import numpy as np
import torch

from rsoderh_raytracing_tpu_torch import _device

MAX_BOUNCES = 10  # shader.wgsl:232
THROUGHPUT_CUTOFF = 0.001  # shader.wgsl:1289


def camera_pytree(camera, device=_device.DEFAULT) -> dict:
    """Host Camera -> dict of f32 tensors on `device`: 'pos' (3,),
    'rot' (3, 3), 'fov_y' ()."""
    device = _device.resolve(device)
    return {
        "pos": torch.tensor(np.asarray(camera.pos, np.float32), device=device),
        "rot": torch.tensor(
            np.asarray(camera.rot_transform(), np.float32), device=device
        ),
        "fov_y": torch.tensor(np.float32(camera.fov_y), device=device),
    }
