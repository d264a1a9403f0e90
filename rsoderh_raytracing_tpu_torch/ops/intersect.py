"""Plain closest-hit and occlusion sweeps over the precomputed scene
constants, plus the winner attributes.

The semantics are those of the reference's unrolled sweep
(rsoderh_raytracing_tpu/ops/pallas_intersect.py:_sweep_body): the same
expanded triple-product tests and epsilons, and a strict-< winner in
sphere -> plane -> triangle, index order. Here the sweep is one
broadcast over lanes x primitives: non-hits are set to INF before one
argmin over [spheres | planes | triangles], whose first minimal index is
exactly that winner (torch's argmin would otherwise prefer NaN). A lane
whose minimum is INF is a miss: type -1, index 0.
"""

from __future__ import annotations

import torch

INF = 3.0e38
SPHERE_EPS = 1.0e-4
PLANE_DENOM_EPS = 1.0e-4
PLANE_T_EPS = 1.0e-3
TRI_DET_EPS = 1.0e-8
TRI_T_EPS = 1.0e-5

# Lanes per broadcast block: bounds the (lanes, primitives) temporaries.
_BLOCK = 1 << 16


def _distances(scene, ox, oy, oz, dx, dy, dz):
    """(n, S+P+T) hit distances, INF where a primitive is not hit."""
    o = [c[:, None] for c in (ox, oy, oz)]
    d = [c[:, None] for c in (dx, dy, dz)]
    ox, oy, oz = o
    dx, dy, dz = d

    # spheres
    a_q = dx * dx + dy * dy + dz * dz
    d_dot_o = dx * ox + dy * oy + dz * oz
    o_dot_o = ox * ox + oy * oy + oz * oz
    cx, cy, cz = (scene.sph_pos[:, k][None, :] for k in range(3))
    b = 2.0 * (d_dot_o - (dx * cx + dy * cy + dz * cz))
    c = o_dot_o - 2.0 * (ox * cx + oy * cy + oz * cz) + scene.sph_c2[None, :]
    disc = b * b - 4.0 * a_q * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    q = torch.where(b > 0, -0.5 * (b + sq), -0.5 * (b - sq))
    t0 = q / a_q
    t1 = c / torch.where(q == 0.0, 1.0, q)
    t = torch.where(
        t0 < SPHERE_EPS,
        t1,
        torch.where(t1 < SPHERE_EPS, t0, torch.minimum(t0, t1)),
    )
    t = torch.where(disc == 0.0, -0.5 * b / a_q, t)
    hit = (disc >= 0.0) & (t >= SPHERE_EPS) & scene.sph_valid[None, :]
    t_sph = torch.where(hit, t, INF)

    # planes
    nx, ny, nz = (scene.pln_normal[:, k][None, :] for k in range(3))
    r0 = [scene.pln_r0[:, k][None, :] for k in range(3)]
    r2 = [scene.pln_r2[:, k][None, :] for k in range(3)]
    denom = dx * nx + dy * ny + dz * nz
    ok = torch.abs(denom) >= PLANE_DENOM_EPS
    t = (scene.pln_ndotp[None, :] - (ox * nx + oy * ny + oz * nz)) / torch.where(
        ok, denom, 1.0
    )
    px = (
        (ox * r0[0] + oy * r0[1] + oz * r0[2])
        + t * (dx * r0[0] + dy * r0[1] + dz * r0[2])
        - scene.pln_r0dotp[None, :]
    )
    pz = (
        (ox * r2[0] + oy * r2[1] + oz * r2[2])
        + t * (dx * r2[0] + dy * r2[1] + dz * r2[2])
        - scene.pln_r2dotp[None, :]
    )
    hit = (
        ok & (t >= PLANE_T_EPS) & (px >= 0.0) & (px <= 1.0)
        & (pz >= 0.0) & (pz <= 1.0) & scene.pln_valid[None, :]
    )
    t_pln = torch.where(hit, t, INF)

    # triangles
    mx = oy * dz - oz * dy
    my = oz * dx - ox * dz
    mz = ox * dy - oy * dx
    cd = [scene.tri_cdet[:, k][None, :] for k in range(3)]
    e0 = [scene.tri_edge0[:, k][None, :] for k in range(3)]
    e1 = [scene.tri_edge1[:, k][None, :] for k in range(3)]
    cu = [scene.tri_cu[:, k][None, :] for k in range(3)]
    cv = [scene.tri_cv[:, k][None, :] for k in range(3)]
    tn = [scene.tri_n[:, k][None, :] for k in range(3)]
    det = dx * cd[0] + dy * cd[1] + dz * cd[2]
    ok = torch.abs(det) >= TRI_DET_EPS
    inv = 1.0 / torch.where(ok, det, 1.0)
    u = (
        (mx * e1[0] + my * e1[1] + mz * e1[2]) + (dx * cu[0] + dy * cu[1] + dz * cu[2])
    ) * inv
    v = -(
        (mx * e0[0] + my * e0[1] + mz * e0[2]) + (dx * cv[0] + dy * cv[1] + dz * cv[2])
    ) * inv
    t = ((ox * tn[0] + oy * tn[1] + oz * tn[2]) - scene.tri_adotn[None, :]) * inv
    hit = (
        ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t >= TRI_T_EPS) & scene.tri_valid[None, :]
    )
    t_tri = torch.where(hit, t, INF)
    return torch.cat([t_sph, t_pln, t_tri], dim=1)


def closest_sweep(scene, ox, oy, oz, dx, dy, dz):
    """(best_t, best_type, best_idx): type 0 sphere / 1 plane / 2 triangle
    / -1 miss (t INF, index 0)."""
    n_sph = scene.sph_radius.shape[0]
    n_pln = scene.pln_valid.shape[0]
    ts, ks = [], []
    for s in range(0, ox.shape[0], _BLOCK):
        sl = slice(s, s + _BLOCK)
        dist = _distances(scene, ox[sl], oy[sl], oz[sl], dx[sl], dy[sl], dz[sl])
        t, k = torch.min(dist, dim=1)
        ts.append(t)
        ks.append(k)
    t = torch.cat(ts)
    k = torch.cat(ks).to(torch.int32)
    miss = ~(t < INF)
    ptype = torch.where(k < n_sph, 0, torch.where(k < n_sph + n_pln, 1, 2))
    pidx = torch.where(k < n_sph, k, torch.where(k < n_sph + n_pln, k - n_sph, k - n_sph - n_pln))
    best_t = torch.where(miss, INF, t)
    best_type = torch.where(miss, -1, ptype).to(torch.int32)
    best_idx = torch.where(miss, 0, pidx).to(torch.int32)
    return best_t, best_type, best_idx


def any_sweep(scene, ox, oy, oz, dx, dy, dz):
    """(n,) bool: some primitive is hit at t < INF."""
    return closest_sweep(scene, ox, oy, oz, dx, dy, dz)[0] < INF


def sphere_normal_values(cx, cy, cz, s_r, ox, oy, oz, px, py, pz):
    """Unit (p - c), flipped when the ray starts inside the sphere."""
    snx, sny, snz = px - cx, py - cy, pz - cz
    inv_len = 1.0 / torch.sqrt(snx * snx + sny * sny + snz * snz)
    snx, sny, snz = snx * inv_len, sny * inv_len, snz * inv_len
    lx, ly, lz = cx - ox, cy - oy, cz - oz
    inside = (lx * lx + ly * ly + lz * lz) - s_r * s_r < 1.0e-6
    return (
        torch.where(inside, -snx, snx),
        torch.where(inside, -sny, sny),
        torch.where(inside, -snz, snz),
    )


def plane_normal_values(pnx, pny, pnz, ox, oy, oz):
    """Plane normal flipped toward the side of the ray ORIGIN (the
    reference's quirk)."""
    flip = ox * pnx + oy * pny + oz * pnz < 0.0
    return (
        torch.where(flip, -pnx, pnx),
        torch.where(flip, -pny, pny),
        torch.where(flip, -pnz, pnz),
    )


def tri_normal_recompute(a, e0, e1, tn0, tn1, tn2, ox, oy, oz, dx, dy, dz):
    """Naive Moller-Trumbore recompute on the winner triangle: barycentric
    blend of the baked normals + backface flip."""
    rx, ry, rz = ox - a[0], oy - a[1], oz - a[2]
    p0x = ry * e0[2] - rz * e0[1]
    p0y = rz * e0[0] - rx * e0[2]
    p0z = rx * e0[1] - ry * e0[0]
    p1x = dy * e1[2] - dz * e1[1]
    p1y = dz * e1[0] - dx * e1[2]
    p1z = dx * e1[1] - dy * e1[0]
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
    backface = tnx * dx + tny * dy + tnz * dz > 0.0
    return (
        torch.where(backface, -tnx, tnx),
        torch.where(backface, -tny, tny),
        torch.where(backface, -tnz, tnz),
    )


def _rows(table, idx):
    rows = table.index_select(0, idx)
    return tuple(rows[:, k] for k in range(rows.shape[1]))


def small_winner_normals(scene, best_type, best_idx, ox, oy, oz, px, py, pz):
    """Sphere and plane winner normals and material ids. A lane whose
    winner is another type reads row 0, like the reference's selects.
    Returns ((snx,sny,snz), (pnx,pny,pnz), m_s, m_p)."""
    idx_s = torch.where(best_type == 0, best_idx, 0)
    idx_p = torch.where(best_type == 1, best_idx, 0)
    cx, cy, cz = _rows(scene.sph_pos, idx_s)
    s_r = scene.sph_radius.index_select(0, idx_s)
    sn = sphere_normal_values(cx, cy, cz, s_r, ox, oy, oz, px, py, pz)
    pn = plane_normal_values(*_rows(scene.pln_normal, idx_p), ox, oy, oz)
    m_s = scene.sph_material.index_select(0, idx_s)
    m_p = scene.pln_material.index_select(0, idx_p)
    return sn, pn, m_s, m_p


def material_values(scene, mat_id):
    """(cr, cg, cb, rough, metal, er, eg, eb) of each lane's material;
    an id outside the table reads row 0, like the reference's selects."""
    n_mat = scene.mat_roughness.shape[0]
    mid = torch.where((mat_id >= 0) & (mat_id < n_mat), mat_id, 0)
    cr, cg, cb = _rows(scene.mat_color, mid)
    er, eg, eb = _rows(scene.mat_emission, mid)
    rough = scene.mat_roughness.index_select(0, mid)
    metal = scene.mat_metallic.index_select(0, mid)
    return cr, cg, cb, rough, metal, er, eg, eb


def trace_attrs(scene, ox, oy, oz, dx, dy, dz, sx, sy, sz):
    """Closest sweep + winner attributes + material values + the NEE
    shadow sweep from the hit point (pallas_intersect.trace_attrs_body).
    Returns a dict of (n,) tensors."""
    best_t, best_type, best_idx = closest_sweep(scene, ox, oy, oz, dx, dy, dz)
    did_hit = best_type >= 0
    t_safe = torch.where(did_hit, best_t, 0.0)
    px = ox + dx * t_safe
    py = oy + dy * t_safe
    pz = oz + dz * t_safe

    (snx, sny, snz), (pnx, pny, pnz), m_s, m_p = small_winner_normals(
        scene, best_type, best_idx, ox, oy, oz, px, py, pz
    )
    idx_t = torch.where(best_type == 2, best_idx, 0)
    tnx, tny, tnz = tri_normal_recompute(
        _rows(scene.tri_a, idx_t), _rows(scene.tri_edge0, idx_t),
        _rows(scene.tri_edge1, idx_t), _rows(scene.tri_n0, idx_t),
        _rows(scene.tri_n1, idx_t), _rows(scene.tri_n2, idx_t),
        ox, oy, oz, dx, dy, dz,
    )
    is_s = best_type == 0
    is_p = best_type == 1
    nx = torch.where(is_s, snx, torch.where(is_p, pnx, tnx))
    ny = torch.where(is_s, sny, torch.where(is_p, pny, tny))
    nz = torch.where(is_s, snz, torch.where(is_p, pnz, tnz))

    m_t = scene.tri_material.index_select(0, idx_t)
    mat_id = torch.where(is_s, m_s, torch.where(is_p, m_p, m_t))
    cr, cg, cb, rough, metal, er, eg, eb = material_values(scene, mat_id)

    occ = any_sweep(scene, px, py, pz, sx, sy, sz)
    return dict(
        did_hit=did_hit, px=px, py=py, pz=pz, nx=nx, ny=ny, nz=nz,
        cr=cr, cg=cg, cb=cb, rough=rough, metal=metal,
        er=er, eg=eg, eb=eb, occ=occ,
    )
