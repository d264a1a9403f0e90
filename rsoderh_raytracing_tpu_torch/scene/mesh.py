"""Wavefront OBJ loader producing packed index-triangle arrays.

Behavior mirrors the reference loader (src/mesh.rs:29-81 + the
``wavefront_obj`` crate semantics it relies on):

- only position + normal indices are used (texcoords ignored),
- polygons (quads etc.) are fan-triangulated from the first corner,
- baked normals are REQUIRED — a face without normal indices is an error,
- multiple ``o`` objects in one file share a single vertex/normal pool with
  per-object offsets,
- all meshes of a scene are concatenated by PackedMeshes.pack
  (src/mesh.rs:84-136).
"""

from __future__ import annotations

import numpy as np

from rsoderh_raytracing_tpu_torch.scene.types import PackedMeshes


class MeshError(ValueError):
    pass


def load_obj(source: str, material_id: int) -> PackedMeshes:
    """Parse OBJ text into a PackedMeshes with a single material id."""
    vertices: list[tuple[float, float, float]] = []
    normals: list[tuple[float, float, float]] = []
    triangles: list[tuple[int, int, int, int, int, int, int]] = []

    # Offsets of the current `o` object into the global pools. The reference
    # parser indexes faces per-object, then adds the object's offsets
    # (src/mesh.rs:37-45). OBJ `f` indices are global 1-based across the
    # whole file, which is equivalent as long as objects only reference
    # their own vertices (true for Blender exports).

    for raw_line in source.splitlines():
        line = raw_line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            vertices.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif tag == "vn":
            normals.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif tag == "f":
            corners = []
            for corner in parts[1:]:
                fields = corner.split("/")
                v_idx = int(fields[0])
                n_idx = None
                if len(fields) >= 3 and fields[2] != "":
                    n_idx = int(fields[2])
                if n_idx is None:
                    raise MeshError("Object must include baked normals")
                # OBJ indices are 1-based; negative indices are relative.
                # Validate range here: index 0 or an over-negative index
                # would otherwise wrap through numpy fancy-indexing into
                # the WRONG vertex silently (or explode later with an
                # opaque IndexError in device-scene construction).
                v_idx = v_idx - 1 if v_idx > 0 else len(vertices) + v_idx
                n_idx = n_idx - 1 if n_idx > 0 else len(normals) + n_idx
                if not (0 <= v_idx < len(vertices)):
                    raise MeshError(
                        f"Face references vertex index out of range:"
                        f" '{raw_line.strip()}'"
                    )
                if not (0 <= n_idx < len(normals)):
                    raise MeshError(
                        f"Face references normal index out of range:"
                        f" '{raw_line.strip()}'"
                    )
                corners.append((v_idx, n_idx))
            # Fan triangulation from the first corner (quad -> 2 tris),
            # matching the wavefront_obj crate used by the reference.
            for i in range(1, len(corners) - 1):
                (v0, n0), (v1, n1), (v2, n2) = (
                    corners[0],
                    corners[i],
                    corners[i + 1],
                )
                triangles.append((v0, v1, v2, n0, n1, n2, material_id))
        # 'o', 'g', 's', 'mtllib', 'usemtl', 'vt' and others are ignored.

    return PackedMeshes(
        vertices=np.asarray(vertices, dtype=np.float32).reshape(-1, 3),
        normals=np.asarray(normals, dtype=np.float32).reshape(-1, 3),
        triangles=np.asarray(triangles, dtype=np.int32).reshape(-1, 7),
    )
