"""The scene files a configuration names, made ready under build/portbench/.

A configuration either names a committed scene file ("scene") or also a
mesh to generate ("generate"): midpoint subdivision with welded edges of
a committed OBJ (a frozen copy of scripts/subdivide_obj.py's arithmetic
and output format), written once to build/portbench/<mesh> and reused by
every later run in the same checkout, with the scene file copied beside
it so that its relative mesh path finds the generated file. Both sides of
a run read the same files.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from portbench.spec import ROOT

BUILD = os.path.join(ROOT, "build", "portbench")


def _load_obj(path):
    verts, norms, faces = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vn":
                norms.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                refs = []
                for p in parts[1:]:
                    comps = p.split("/")
                    ni = int(comps[2]) - 1 if len(comps) > 2 and comps[2] else 0
                    refs.append((int(comps[0]) - 1, ni))
                for k in range(1, len(refs) - 1):
                    faces.append([refs[0], refs[k], refs[k + 1]])
    return verts, norms, faces


def _subdivide(verts, norms, faces):
    verts = list(map(tuple, verts))
    norms = list(map(tuple, norms))
    edge_mid = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key in edge_mid:
            return edge_mid[key]
        (va, na), (vb, nb) = a, b
        v = tuple((x + y) / 2.0 for x, y in zip(verts[va], verts[vb]))
        nsum = [x + y for x, y in zip(norms[na], norms[nb])]
        length = float(np.sqrt(sum(x * x for x in nsum))) or 1.0
        verts.append(v)
        norms.append(tuple(x / length for x in nsum))
        ref = (len(verts) - 1, len(norms) - 1)
        edge_mid[key] = ref
        return ref

    out = []
    for a, b, c in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        out.extend([[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]])
    return verts, norms, out


def _write_obj(path, verts, norms, faces, comment):
    lines = [f"# {comment}\n", "o Suzanne_hi\n"]
    lines += [f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n" for v in verts]
    lines += [f"vn {n[0]:.4f} {n[1]:.4f} {n[2]:.4f}\n" for n in norms]
    lines.append("s 1\n")
    lines += [f"f {va + 1}//{na + 1} {vb + 1}//{nb + 1} {vc + 1}//{nc + 1}\n"
              for (va, na), (vb, nb), (vc, nc) in faces]
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.writelines(lines)
    os.replace(tmp, path)


def scene_path(config) -> str:
    """Absolute path of the configuration's scene file, generating its
    mesh first where the configuration asks for one."""
    scene = os.path.join(ROOT, config["scene"])
    gen = config.get("generate")
    if not gen:
        return scene
    scenes = os.path.join(BUILD, "scenes")
    os.makedirs(scenes, exist_ok=True)
    mesh = os.path.join(BUILD, gen["mesh"])
    if not os.path.exists(mesh):
        verts, norms, faces = _load_obj(os.path.join(ROOT, gen["from"]))
        for _ in range(int(gen["levels"])):
            verts, norms, faces = _subdivide(verts, norms, faces)
        _write_obj(mesh, verts, norms, faces,
                   f"{gen['from']} midpoint-subdivided x{gen['levels']} ({len(faces)} triangles)")
    copy = os.path.join(scenes, os.path.basename(scene))
    if not os.path.exists(copy):
        tmp = f"{copy}.tmp{os.getpid()}"
        shutil.copyfile(scene, tmp)
        os.replace(tmp, copy)
    return copy
