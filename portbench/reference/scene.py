"""The scene as the reference reads it: the upstream TOML format (materials
and Sphere, Plane and Mesh objects with baked-normal OBJ files, the camera
in degrees), parsed here, and the primitives' intersection constants
worked out from it in the host's order with no padding (frozen copies of
the port's scene/toml_loader.py, scene/mesh.py, scene/types.py and
build_device_scene's arithmetic).
"""

from __future__ import annotations

import dataclasses
import math
import os
import tomllib

import numpy as np
import torch


def load_obj(source: str, material_id: int):
    """(vertices (V, 3) f32, normals (N, 3) f32, triangles (T, 7) int32 rows
    v0 v1 v2 n0 n1 n2 material) of OBJ text, fan-triangulated."""
    verts, norms, tris = [], [], []
    for raw in source.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if parts[0] == "v":
            verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif parts[0] == "vn":
            norms.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif parts[0] == "f":
            corners = []
            for corner in parts[1:]:
                fields = corner.split("/")
                if len(fields) < 3 or fields[2] == "":
                    raise ValueError("an OBJ face without baked normals")
                v, n = int(fields[0]), int(fields[2])
                corners.append((v - 1 if v > 0 else len(verts) + v, n - 1 if n > 0 else len(norms) + n))
            for i in range(1, len(corners) - 1):
                (v0, n0), (v1, n1), (v2, n2) = corners[0], corners[i], corners[i + 1]
                tris.append((v0, v1, v2, n0, n1, n2, material_id))
    return (np.asarray(verts, np.float32).reshape(-1, 3), np.asarray(norms, np.float32).reshape(-1, 3),
            np.asarray(tris, np.int32).reshape(-1, 7))


def camera_rotation(yaw: float, pitch: float) -> np.ndarray:
    """Camera-to-world rotation Ry(yaw) @ Rx(pitch), float32."""
    cy, sy, cp, sp = math.cos(yaw), math.sin(yaw), math.cos(pitch), math.sin(pitch)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], dtype=np.float32)
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], dtype=np.float32)
    return (ry @ rx).astype(np.float32)


def camera_tensors(pos, yaw, pitch, fov_y, device) -> dict:
    """{'pos' (3,), 'rot' (3, 3), 'fov_y' ()} float32 tensors of a camera
    (angles in radians)."""
    return {
        "pos": torch.tensor(np.asarray(pos, np.float32), device=device),
        "rot": torch.tensor(camera_rotation(float(yaw), float(pitch)), device=device),
        "fov_y": torch.tensor(np.float32(fov_y), device=device),
    }


@dataclasses.dataclass
class RefScene:
    """Float32 tensors of every primitive (no padding) and its material
    rows, plus the camera of the file (position, yaw, pitch and fov_y in
    radians)."""

    t: dict
    camera: tuple

    def __getattr__(self, name):
        try:
            return self.__dict__["t"][name]
        except KeyError as err:
            raise AttributeError(name) from err

    @property
    def device(self):
        return self.t["mat_color"].device


def load_scene(path: str, device) -> RefScene:
    with open(path, "rb") as f:
        desc = tomllib.load(f)
    base = os.path.dirname(path) or "."
    mats = desc.get("material", [])
    index = {}
    for i, m in enumerate(mats):
        index.setdefault(m["name"], i)
    m_n = max(1, len(mats))
    mat_color = np.zeros((m_n, 3), np.float32)
    mat_rough = np.zeros(m_n, np.float32)
    mat_metal = np.zeros(m_n, np.float32)
    mat_emit = np.zeros((m_n, 3), np.float32)
    for i, m in enumerate(mats):
        mat_color[i], mat_rough[i], mat_metal[i], mat_emit[i] = (
            m["color"], m["roughness"], m["metallic"], m["emission"])
    spheres, planes, meshes = [], [], []
    for obj in desc.get("object", []):
        ((kind, body),) = obj.items()
        mid = index[body["material"]]
        if kind == "Sphere":
            spheres.append((np.asarray(body["pos"], np.float32), np.float32(body["radius"]), mid))
        elif kind == "Plane":
            planes.append(tuple(np.asarray(body[k], np.float32) for k in ("pos", "forward", "right")) + (mid,))
        elif kind == "Mesh":
            with open(os.path.join(base, body["path"])) as f:
                meshes.append(load_obj(f.read(), mid))
        else:
            raise ValueError(f"unknown object type {kind!r}")

    sph_pos = np.asarray([s[0] for s in spheres], np.float32).reshape(-1, 3)
    sph_radius = np.asarray([s[1] for s in spheres], np.float32)
    sph_mat = np.asarray([s[2] for s in spheres], np.int32)
    pln_pos = np.asarray([p[0] for p in planes], np.float32).reshape(-1, 3)
    normals, bcms = [], []
    for pos, forward, right, _ in planes:
        n = np.cross(forward, right)
        n = (n / np.linalg.norm(n)).astype(np.float32)
        normals.append(n)
        bcms.append(np.linalg.inv(np.stack([right, n, forward], axis=1).astype(np.float64)).astype(np.float32))
    pln_normal = np.asarray(normals, np.float32).reshape(-1, 3)
    pln_bcm = np.asarray(bcms, np.float32).reshape(-1, 3, 3)
    pln_mat = np.asarray([p[3] for p in planes], np.int32)

    v_off = n_off = 0
    tris = []
    verts, norms = [], []
    for v, n, t in meshes:
        t = t.copy()
        t[:, 0:3] += v_off
        t[:, 3:6] += n_off
        tris.append(t)
        verts.append(v)
        norms.append(n)
        v_off += len(v)
        n_off += len(n)
    tris = np.concatenate(tris) if tris else np.zeros((0, 7), np.int32)
    v = np.concatenate(verts) if verts else np.zeros((0, 3), np.float32)
    n = np.concatenate(norms) if norms else np.zeros((0, 3), np.float32)
    a, b, c = v[tris[:, 0]], v[tris[:, 1]], v[tris[:, 2]]
    e0, e1 = b - a, c - a

    arrays = dict(
        mat_color=mat_color, mat_roughness=mat_rough, mat_metallic=mat_metal, mat_emission=mat_emit,
        sph_pos=sph_pos, sph_radius=sph_radius, sph_material=sph_mat,
        sph_c2=((sph_pos.astype(np.float64) ** 2).sum(-1) - sph_radius.astype(np.float64) ** 2),
        pln_pos=pln_pos, pln_normal=pln_normal, pln_material=pln_mat,
        pln_ndotp=(pln_normal * pln_pos).sum(-1),
        pln_r0=pln_bcm[:, 0, :], pln_r2=pln_bcm[:, 2, :],
        pln_r0dotp=(pln_bcm[:, 0, :] * pln_pos).sum(-1), pln_r2dotp=(pln_bcm[:, 2, :] * pln_pos).sum(-1),
        tri_a=a, tri_edge0=e0, tri_edge1=e1,
        tri_n0=n[tris[:, 3]], tri_n1=n[tris[:, 4]], tri_n2=n[tris[:, 5]], tri_material=tris[:, 6],
        tri_cdet=np.cross(e1, e0), tri_cu=np.cross(a, e1), tri_cv=np.cross(a, e0),
        tri_n=np.cross(e0, e1),
    )
    arrays["tri_adotn"] = (a * arrays["tri_n"]).sum(-1)
    t = {}
    for k, arr in arrays.items():
        arr = np.ascontiguousarray(arr.astype(np.int32 if k.endswith("_material") else np.float32))
        t[k] = torch.from_numpy(arr).to(device)
    cam = desc["camera"]
    camera = (np.asarray(cam["pos"], np.float32), math.radians(cam["yaw"]),
              math.radians(cam["pitch"]), math.radians(cam["fov_y"]))
    return RefScene(t=t, camera=camera)
