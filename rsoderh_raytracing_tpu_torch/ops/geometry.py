"""The closest-hit record (port of HitRecord in
rsoderh_raytracing_tpu/ops/geometry.py). The primitive tests and the
winner normals live in ops/intersect.py."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class HitRecord:
    """Closest-hit result of a ray batch; vectors are 3-tuples of (n,)
    tensors. A miss lane holds distance 0, the ray origin as point and
    row 0's attributes, like the reference."""

    did_hit: torch.Tensor  # (n,) bool
    distance: torch.Tensor  # (n,) f32, 0 on a miss
    point: tuple
    normal: tuple
    material_id: torch.Tensor  # (n,) int32
