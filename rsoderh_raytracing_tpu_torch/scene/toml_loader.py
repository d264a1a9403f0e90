"""TOML scene descriptor loader.

Accepts the exact schema of the reference (src/scene.rs:264-322):

    [[material]]
    name = "..."        # referenced by name from objects
    color = [r, g, b]
    roughness = 1.0
    metallic = 0.0
    emission = [r, g, b]

    [[object]]
    [object.Sphere]     # serde tagged-enum shape: Sphere | Plane | Mesh
    material = "..."
    pos = [x, y, z]
    radius = 1.0

    [camera]
    pos = [x, y, z]
    yaw = 0.0           # degrees in the file, radians in memory
    pitch = 0.0
    fov_y = 100.0

Mesh paths are resolved relative to the TOML file
(reference: src/scene.rs:407-412).
"""

from __future__ import annotations

import math
import os
import tomllib

from rsoderh_raytracing_tpu_torch.scene.camera import Camera
from rsoderh_raytracing_tpu_torch.scene.mesh import load_obj
from rsoderh_raytracing_tpu_torch.scene.types import (
    Material,
    PackedMeshes,
    Plane,
    Scene,
    Sphere,
)


class SceneError(ValueError):
    pass


def load_scene(path: str) -> Scene:
    try:
        with open(path, "rb") as f:
            descriptor = tomllib.load(f)
    except OSError as err:
        raise SceneError(f"Couldn't open scene {path}:\n  {err}") from err
    except tomllib.TOMLDecodeError as err:
        raise SceneError(f"Couldn't parse scene {path}:\n  {err}") from err
    try:
        return build_scene(descriptor, path)
    except KeyError as err:
        # Missing required tables/fields ([camera], a sphere's 'radius',
        # a material's 'roughness', ...) otherwise escape as raw
        # KeyError tracebacks instead of the loader's error contract
        # (the reference emits a clean serde error for the same input).
        raise SceneError(
            f"Invalid scene {path}: missing required field {err}"
        ) from err


def build_scene(descriptor: dict, descriptor_path: str) -> Scene:
    material_descrs = descriptor.get("material", [])
    materials = [
        Material(
            color=m["color"],
            roughness=m["roughness"],
            metallic=m["metallic"],
            emission=m["emission"],
        )
        for m in material_descrs
    ]
    # Material names resolve to their index, first match wins
    # (reference: src/scene.rs:326-332).
    name_to_index: dict[str, int] = {}
    for index, m in enumerate(material_descrs):
        name_to_index.setdefault(m["name"], index)

    def material_index(obj_index: int, type_: str, name: str) -> int:
        if name not in name_to_index:
            raise SceneError(
                f"Error in object {obj_index} ({type_}): Material '{name}'"
                f" does not exist.\n  --> {descriptor_path}"
            )
        return name_to_index[name]

    spheres: list[Sphere] = []
    planes: list[Plane] = []
    meshes: list[PackedMeshes] = []
    base_dir = os.path.dirname(descriptor_path) or "."

    for i, obj in enumerate(descriptor.get("object", [])):
        if len(obj) != 1:
            raise SceneError(
                f"Error in object {i}: expected exactly one of"
                f" Sphere/Plane/Mesh.\n  --> {descriptor_path}"
            )
        ((type_, body),) = obj.items()
        if type_ == "Sphere":
            spheres.append(
                Sphere(
                    pos=body["pos"],
                    radius=body["radius"],
                    material_id=material_index(i, type_, body["material"]),
                )
            )
        elif type_ == "Plane":
            planes.append(
                Plane(
                    pos=body["pos"],
                    forward=body["forward"],
                    right=body["right"],
                    material_id=material_index(i, type_, body["material"]),
                )
            )
        elif type_ == "Mesh":
            mesh_path = os.path.join(base_dir, body["path"])
            try:
                with open(mesh_path, "r") as f:
                    content = f.read()
            except OSError as err:
                raise SceneError(
                    f"Error in object {i} (Mesh): Cannot open"
                    f" '{body['path']}': {err}\n  --> {descriptor_path}"
                ) from err
            meshes.append(
                load_obj(content, material_index(i, type_, body["material"]))
            )
        else:
            raise SceneError(
                f"Error in object {i}: unknown object type '{type_}'."
                f"\n  --> {descriptor_path}"
            )

    cam = descriptor["camera"]
    camera = Camera(
        pos=cam["pos"],
        yaw=math.radians(cam["yaw"]),
        pitch=math.radians(cam["pitch"]),
        fov_y=math.radians(cam["fov_y"]),
    )

    return Scene(
        materials=materials,
        spheres=spheres,
        planes=planes,
        meshes=PackedMeshes.pack(meshes),
        camera=camera,
    )
