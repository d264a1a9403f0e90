"""Closest-hit and occlusion queries of the reference, in plain PyTorch.

Two sets of primitive formulas, both the upstream shader's tests with its
epsilons, which round differently:

- "expanded": the unrolled sweep's triple-product forms over the scene's
  precomputed constants (sphere q-form, plane numerator over n.p,
  triangle numerators over e1 x e0, a x e1, a x e0, e0 x e1);
- "direct": the BVH walk's leaf tests (Moller-Trumbore from the corner
  and edges, the plane through its base change, the sphere from the
  centre), with the expanded sphere and plane sweep as the closest
  query's fallback where nothing is hit.

The closest winner is the least (t, kind, index), kind sphere < plane <
triangle, as a packed int64 key: the first minimal primitive in
[spheres | planes | triangles] order. Past DENSE_TRIS triangles a ray
tests only the triangles of the 64-triangle chunks (consecutive in a
Morton order of the centroids, worked out here) whose inflated box its
slab passes; the key keeps the winner independent of that order.
"""

from __future__ import annotations

import torch

INF = 3.0e38
SPHERE_EPS = 1.0e-4
PLANE_DENOM_EPS = 1.0e-4
PLANE_T_EPS = 1.0e-3
TRI_DET_EPS = 1.0e-8
TRI_T_EPS = 1.0e-5
SPHERE, PLANE, TRIANGLE = 0, 1, 2
DENSE_TRIS = 4096
CHUNK = 64
# (ray, primitive) pairs a block: the temporaries are a few dozen times
# 4 bytes a pair
PAIRS = {"cpu": 1 << 20, "cuda": 1 << 24}
MISS_KEY = int(torch.tensor(INF, dtype=torch.float32).view(torch.int32)) << 32


def pack_key(t, kind, idx):
    bits = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return (bits << 32) | (int(kind) << 28) | idx.to(torch.int64)


def unpack_key(key):
    hit = key < MISS_KEY
    t = (key >> 32).to(torch.int32).view(torch.float32)
    low = key & 0xFFFFFFFF
    return (torch.where(hit, t, INF), torch.where(hit, low >> 28, -1).to(torch.int32),
            torch.where(hit, low & 0x0FFFFFFF, 0).to(torch.int32))


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _col(field, rows):
    """Columns of the (n, 3) field at `rows` ((m, k) indices), each (m, k)."""
    return tuple(field[:, c][rows] for c in range(3))


# -- expanded forms ------------------------------------------------------------


def _sphere_expanded(s, r, rows):
    (ox, oy, oz), (dx, dy, dz) = r["o"], r["d"]
    cx, cy, cz = _col(s.sph_pos, rows)
    b = 2.0 * (r["d_dot_o"] - (dx * cx + dy * cy + dz * cz))
    c = r["o_dot_o"] - 2.0 * (ox * cx + oy * cy + oz * cz) + s.sph_c2[rows]
    disc = b * b - 4.0 * r["a_q"] * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    q = torch.where(b > 0, -0.5 * (b + sq), -0.5 * (b - sq))
    t0 = q / r["a_q"]
    t1 = c / torch.where(q == 0.0, 1.0, q)
    t = torch.where(t0 < SPHERE_EPS, t1, torch.where(t1 < SPHERE_EPS, t0, torch.minimum(t0, t1)))
    t = torch.where(disc == 0.0, -0.5 * b / r["a_q"], t)
    return t, (disc >= 0.0) & (t >= SPHERE_EPS)


def _plane_expanded(s, r, rows):
    (ox, oy, oz), (dx, dy, dz) = r["o"], r["d"]
    nx, ny, nz = _col(s.pln_normal, rows)
    r0, r2 = _col(s.pln_r0, rows), _col(s.pln_r2, rows)
    denom = dx * nx + dy * ny + dz * nz
    num = s.pln_ndotp[rows] - (ox * nx + oy * ny + oz * nz)
    ok = torch.abs(denom) >= PLANE_DENOM_EPS
    t = num / torch.where(ok, denom, 1.0)
    px = ((ox * r0[0] + oy * r0[1] + oz * r0[2]) + t * (dx * r0[0] + dy * r0[1] + dz * r0[2])
          - s.pln_r0dotp[rows])
    pz = ((ox * r2[0] + oy * r2[1] + oz * r2[2]) + t * (dx * r2[0] + dy * r2[1] + dz * r2[2])
          - s.pln_r2dotp[rows])
    return t, ok & (t >= PLANE_T_EPS) & (px >= 0.0) & (px <= 1.0) & (pz >= 0.0) & (pz <= 1.0)


def _triangle_expanded(s, r, rows):
    (ox, oy, oz), (dx, dy, dz) = r["o"], r["d"]
    mx, my, mz = r["m"]
    cd, e0, e1 = _col(s.tri_cdet, rows), _col(s.tri_edge0, rows), _col(s.tri_edge1, rows)
    cu, cv, tn = _col(s.tri_cu, rows), _col(s.tri_cv, rows), _col(s.tri_n, rows)
    det = dx * cd[0] + dy * cd[1] + dz * cd[2]
    un = (mx * e1[0] + my * e1[1] + mz * e1[2]) + (dx * cu[0] + dy * cu[1] + dz * cu[2])
    vn = -((mx * e0[0] + my * e0[1] + mz * e0[2]) + (dx * cv[0] + dy * cv[1] + dz * cv[2]))
    tnum = (ox * tn[0] + oy * tn[1] + oz * tn[2]) - s.tri_adotn[rows]
    ok = torch.abs(det) >= TRI_DET_EPS
    inv = 1.0 / torch.where(ok, det, 1.0)
    u, v, t = un * inv, vn * inv, tnum * inv
    return t, ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= TRI_T_EPS)


# -- direct forms ----------------------------------------------------------------


def _sphere_direct(s, r, rows):
    o, d = r["o"], r["d"]
    lv = tuple(o[k] - c for k, c in enumerate(_col(s.sph_pos, rows)))
    radius = s.sph_radius[rows]
    a = _dot(d, d)
    b = 2.0 * _dot(d, lv)
    c = _dot(lv, lv) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    q = torch.where(b > 0, -0.5 * (b + sq), -0.5 * (b - sq))
    t0 = q / a
    t1 = c / torch.where(q == 0, 1.0, q)
    t = torch.where(t0 < SPHERE_EPS, t1, torch.where(t1 < SPHERE_EPS, t0, torch.minimum(t0, t1)))
    t = torch.where(disc == 0.0, -0.5 * b / a, t)
    return t, (disc >= 0.0) & (t >= SPHERE_EPS)


def _plane_direct(s, r, rows):
    o, d = r["o"], r["d"]
    pos, normal = _col(s.pln_pos, rows), _col(s.pln_normal, rows)
    denom = _dot(normal, d)
    ok = torch.abs(denom) >= PLANE_DENOM_EPS
    t = _dot(normal, tuple(p - q for p, q in zip(pos, o))) / torch.where(ok, denom, 1.0)
    inter = tuple(o[k] + d[k] * t - pos[k] for k in range(3))
    x = _dot(_col(s.pln_r0, rows), inter)
    z = _dot(_col(s.pln_r2, rows), inter)
    return t, ok & (t >= PLANE_T_EPS) & (x >= 0) & (x <= 1) & (z >= 0) & (z <= 1)


def _triangle_direct(s, r, rows):
    o, d = r["o"], r["d"]
    a, e0, e1 = _col(s.tri_a, rows), _col(s.tri_edge0, rows), _col(s.tri_edge1, rows)
    rel = tuple(o[k] - a[k] for k in range(3))
    p0 = _cross(rel, e0)
    p1 = _cross(d, e1)
    det = _dot(e0, p1)
    ok = torch.abs(det) >= TRI_DET_EPS
    inv = 1.0 / torch.where(ok, det, 1.0)
    u = _dot(rel, p1) * inv
    v = _dot(d, p0) * inv
    t = _dot(e1, p0) * inv
    return t, ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= TRI_T_EPS)


TESTS = {
    "expanded": {SPHERE: _sphere_expanded, PLANE: _plane_expanded, TRIANGLE: _triangle_expanded},
    "direct": {SPHERE: _sphere_direct, PLANE: _plane_direct, TRIANGLE: _triangle_direct},
}


def _terms(o, d):
    """Ray terms broadcast against a (m, k) block of primitives."""
    o = tuple(c[:, None] for c in o)
    d = tuple(c[:, None] for c in d)
    (ox, oy, oz), (dx, dy, dz) = o, d
    return dict(o=o, d=d, a_q=dx * dx + dy * dy + dz * dz, d_dot_o=dx * ox + dy * oy + dz * oz,
                o_dot_o=ox * ox + oy * oy + oz * oz,
                m=(oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx))


def _count(s, kind):
    return (s.sph_radius, s.pln_ndotp, s.tri_adotn)[kind].shape[0]


def _chunks(s):
    """(order (T,) int64, boxes (C, 6)) of the triangles' Morton chunks,
    cached on the scene."""
    if "_chunks" in s.t:
        return s.t["_chunks"]
    a, e0, e1 = s.tri_a, s.tri_edge0, s.tri_edge1
    cent = (a + (a + e0) + (a + e1)) / 3.0
    lo, hi = cent.min(0).values, cent.max(0).values
    q = ((cent - lo) / torch.clamp_min(hi - lo, 1e-12) * 1023.0).clamp(0, 1023).to(torch.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    order = torch.argsort((spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2]), stable=True)
    n = order.shape[0]
    pad = (-n) % CHUNK
    order = torch.cat([order, order[-1:].expand(pad)]) if pad else order
    corners = torch.stack([a, a + e0, a + e1], dim=1)[order].reshape(-1, CHUNK * 3, 3)
    lo, hi = corners.min(1).values, corners.max(1).values
    margin = 1e-4 * (hi - lo).abs().amax(1, keepdim=True) + 1e-5
    boxes = torch.cat([lo - margin, hi + margin], dim=1)
    s.t["_chunks"] = (order.reshape(-1, CHUNK), boxes)
    return s.t["_chunks"]


def _slab(o, d, boxes):
    """(m, C) bool: the ray's slab passes the box, from t = 0 on."""
    t0 = torch.zeros((o[0].shape[0], boxes.shape[0]), device=o[0].device)
    t1 = torch.full_like(t0, INF)
    for a in range(3):
        inv = (1.0 / d[a])[:, None]
        near = (boxes[None, :, a] - o[a][:, None]) * inv
        far = (boxes[None, :, 3 + a] - o[a][:, None]) * inv
        lo = torch.nan_to_num(torch.minimum(near, far), nan=-INF)
        hi = torch.nan_to_num(torch.maximum(near, far), nan=INF)
        t0, t1 = torch.maximum(t0, lo), torch.minimum(t1, hi)
    return t0 <= t1


def _kind_rows(s, kind, o, d, visit):
    """Call visit(lane indices (m,), ray terms, rows (m, k)) over every
    (lane, primitive) pair of `kind` that a ray may hit, in blocks."""
    n = o[0].shape[0]
    dev = o[0].device
    pairs = PAIRS.get(dev.type, PAIRS["cpu"])
    count = _count(s, kind)
    if count == 0 or n == 0:
        return
    if kind != TRIANGLE or count <= DENSE_TRIS:
        rows_all = torch.arange(count, device=dev)
        step = max(1, pairs // count)
        for lo in range(0, n, step):
            lanes = torch.arange(lo, min(n, lo + step), device=dev)
            sub = (tuple(c[lanes] for c in o), tuple(c[lanes] for c in d))
            visit(lanes, _terms(*sub), rows_all[None, :].expand(lanes.shape[0], count))
        return
    order, boxes = _chunks(s)
    step = max(1, pairs // boxes.shape[0])
    for lo in range(0, n, step):
        lanes = torch.arange(lo, min(n, lo + step), device=dev)
        which, chunk = torch.nonzero(_slab(tuple(c[lanes] for c in o), tuple(c[lanes] for c in d), boxes),
                                     as_tuple=True)
        per = max(1, pairs // CHUNK)
        for b in range(0, which.shape[0], per):
            pl = lanes[which[b:b + per]]
            visit(pl, _terms(tuple(c[pl] for c in o), tuple(c[pl] for c in d)), order[chunk[b:b + per]])


def closest(s, o, d, formulas, kinds=(SPHERE, PLANE, TRIANGLE)):
    """(t, type, index) of the closest primitive of `kinds` along each ray
    (3-tuples of (n,) f32): a miss is (INF, -1, 0)."""
    n = o[0].shape[0]
    key = torch.full((n,), MISS_KEY, dtype=torch.int64, device=o[0].device)
    tests = TESTS[formulas]
    for kind in kinds:
        def visit(lanes, r, rows, kind=kind):
            t, hit = tests[kind](s, r, rows)
            cand = torch.where(hit, pack_key(torch.where(hit, t, 1.0), kind, rows), MISS_KEY)
            key.scatter_reduce_(0, lanes, cand.min(dim=1).values, reduce="amin")
        _kind_rows(s, kind, o, d, visit)
    if formulas == "direct":
        # the walk's fallback: the expanded sphere and plane sweep where
        # the walk found nothing
        missed = torch.nonzero(key >= MISS_KEY).squeeze(1)
        if missed.numel():
            t, ptype, pidx = closest(s, tuple(c[missed] for c in o), tuple(c[missed] for c in d),
                                     "expanded", (SPHERE, PLANE))
            key[missed] = torch.where(ptype >= 0, pack_key(t, 0, pidx) | (ptype.clamp_min(0).long() << 28),
                                      MISS_KEY)
    return unpack_key(key)


def occluded(s, o, d, formulas):
    """(n,) bool: some primitive is hit along the ray (t above its kind's
    epsilon; the walk's leaf tests under "direct", which has no
    fallback)."""
    n = o[0].shape[0]
    occ = torch.zeros(n, dtype=torch.bool, device=o[0].device)
    tests = TESTS[formulas]
    for kind in (SPHERE, PLANE, TRIANGLE):
        def visit(lanes, r, rows, kind=kind):
            occ.index_fill_(0, lanes[tests[kind](s, r, rows)[1].any(dim=1)], True)
        _kind_rows(s, kind, o, d, visit)
    return occ


# -- the winner's attributes (the port's _hit_attributes) -----------------------


def hit_attributes(s, ro, rd, t, ptype, pidx):
    """(did_hit, point, normal, material values (cr, cg, cb, rough, metal,
    er, eg, eb)) of each lane's winner; a lane whose winner is another
    kind reads that kind's row 0, a miss the triangle branch."""
    did_hit = ptype >= 0
    t_safe = torch.where(did_hit, t, 0.0)
    point = tuple(ro[k] + rd[k] * t_safe for k in range(3))
    idx_s = torch.where(ptype == 0, pidx, 0).long()
    idx_p = torch.where(ptype == 1, pidx, 0).long()
    idx_t = torch.where(ptype == 2, pidx, 0).long()

    def rows(field, idx):
        if field.shape[0] == 0:
            return tuple(torch.zeros_like(t) for _ in range(3)) if field.dim() == 2 else torch.zeros_like(t)
        r = field[idx]
        return tuple(r[:, k] for k in range(3)) if r.dim() == 2 else r

    # sphere: unit (p - c), flipped when the ray starts inside
    cx, cy, cz = rows(s.sph_pos, idx_s)
    s_r = rows(s.sph_radius, idx_s)
    snx, sny, snz = point[0] - cx, point[1] - cy, point[2] - cz
    inv_len = 1.0 / torch.sqrt(snx * snx + sny * sny + snz * snz)
    snx, sny, snz = snx * inv_len, sny * inv_len, snz * inv_len
    lx, ly, lz = cx - ro[0], cy - ro[1], cz - ro[2]
    inside = (lx * lx + ly * ly + lz * lz) - s_r * s_r < 1.0e-6
    sn = tuple(torch.where(inside, -c, c) for c in (snx, sny, snz))
    # plane: the normal flipped toward the ray origin's side
    pnx, pny, pnz = rows(s.pln_normal, idx_p)
    flip = ro[0] * pnx + ro[1] * pny + ro[2] * pnz < 0.0
    pn = tuple(torch.where(flip, -c, c) for c in (pnx, pny, pnz))
    # triangle: barycentric blend of the baked normals, backface flipped
    a, e0, e1 = rows(s.tri_a, idx_t), rows(s.tri_edge0, idx_t), rows(s.tri_edge1, idx_t)
    tn0, tn1, tn2 = rows(s.tri_n0, idx_t), rows(s.tri_n1, idx_t), rows(s.tri_n2, idx_t)
    (ox, oy, oz), (dx, dy, dz) = ro, rd
    rx, ry, rz = ox - a[0], oy - a[1], oz - a[2]
    p0x, p0y, p0z = ry * e0[2] - rz * e0[1], rz * e0[0] - rx * e0[2], rx * e0[1] - ry * e0[0]
    p1x, p1y, p1z = dy * e1[2] - dz * e1[1], dz * e1[0] - dx * e1[2], dx * e1[1] - dy * e1[0]
    det = e0[0] * p1x + e0[1] * p1y + e0[2] * p1z
    inv_det = 1.0 / torch.where(torch.abs(det) < TRI_DET_EPS, 1.0, det)
    u = (rx * p1x + ry * p1y + rz * p1z) * inv_det
    v = (dx * p0x + dy * p0y + dz * p0z) * inv_det
    w0 = 1.0 - u - v
    tnx = w0 * tn0[0] + u * tn1[0] + v * tn2[0]
    tny = w0 * tn0[1] + u * tn1[1] + v * tn2[1]
    tnz = w0 * tn0[2] + u * tn1[2] + v * tn2[2]
    inv_tn = 1.0 / torch.clamp_min(torch.sqrt(tnx * tnx + tny * tny + tnz * tnz), 1.0e-20)
    tnx, tny, tnz = tnx * inv_tn, tny * inv_tn, tnz * inv_tn
    back = tnx * dx + tny * dy + tnz * dz > 0.0
    tn = tuple(torch.where(back, -c, c) for c in (tnx, tny, tnz))
    is_s, is_p = ptype == 0, ptype == 1
    normal = tuple(torch.where(is_s, sn[k], torch.where(is_p, pn[k], tn[k])) for k in range(3))
    mat = torch.where(is_s, rows(s.sph_material, idx_s),
                      torch.where(is_p, rows(s.pln_material, idx_p), rows(s.tri_material, idx_t)))
    n_mat = s.mat_roughness.shape[0]
    mid = torch.where((mat >= 0) & (mat < n_mat), mat, 0).long()
    color, emis = s.mat_color[mid], s.mat_emission[mid]
    values = (color[:, 0], color[:, 1], color[:, 2], s.mat_roughness[mid], s.mat_metallic[mid],
              emis[:, 0], emis[:, 1], emis[:, 2])
    return did_hit, point, normal, values
