"""The BVH route's scene data and its plain walks (port of
rsoderh_raytracing_tpu/ops/bvh_traverse.py and of intersect._sweep_bvh).

``DeviceBVH`` holds the tables the BVH_CLOSEST and BVH_ANY kernels
(csrc/bvh.cu) read: one 12-float row a node (the reference's
``_node_table`` with its three integers bit-cast into float lanes and
padded to three 16-byte words: min xyz, payload | max xyz, count | axis,
0, 0, 0; the plain walks walk it, the kernels read the root's box from
it), one 16-float child-pair row an interior node (``pair_table``: both
children's boxes and references, the split axis; what the kernels walk),
and the reference's 16-float leaf rows in slot order
(``_prim_table``: triangle a, e0, e1; sphere centre, radius; plane pos,
normal, the 9 base-change entries; column 15 the bit-cast type tag),
plus the slot -> (type, index) arrays and the sphere and plane rows of
the closest walk's fallback (scene/device.pack_rows).

``traverse_closest`` and ``traverse_any`` walk the tree as the
reference's while-loops do, one lane at a time in tensor code (the
running lanes are compacted every step): best-t pruning, both children's
boxes tested at the parent, the near child first by the sign of 1/rd on
the split axis, the far one pushed with its entry time and re-pruned when
popped (``cur_entry <= best_t``), leaf slots tested in slot order with a
strict ``<`` winner, and the reference's leaf tests (``_sphere_t``,
``_plane_t``, ``_triangle_t``: the direct formulas, not the sweep's
expanded ones). Sums of three products are written left to right, so the
kernels, built with -fmad=false, round as these do. The slab test drops a
NaN axis (entry 0, exit 3e38) as ``geometry.ray_bounds_entry`` does.

``closest_plain`` and ``any_plain`` are the kernels' plain twins:
BVH_CLOSEST is the walk, then on a BVH miss the reference's linear sphere
and plane fallback (intersect._sweep_bvh; the sweep of ops/intersect.py);
BVH_ANY is the walk alone (the reference's occlusion has no fallback).
Lanes outside the mask get the miss record (3e38, -1, 0) or 0. Each walk
can also count what it does (``counts``): node visits, box tests, and
leaf tests of each primitive kind, from which profiling.bvh_bound works
out the kernels' bound. Nothing on a render path calls these with a CUDA
tensor: the wrappers (ops/cuda_intersect.py) launch the kernels there.

``walk_model`` walks the child-pair rows as the kernels walk each ray:
the lanes that enter the root's box in lane order, both children's boxes
from one row, popping past pruned entries. It gives the plain walks'
outputs and counts exactly (the tests hold it to them), which is why
profiling.bvh_bound may take the plain walks' counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rsoderh_raytracing_tpu_torch.accel.bvh import TRAVERSAL_STACK_DEPTH, FlatBVH
from rsoderh_raytracing_tpu_torch.ops.intersect import (
    INF, PLANE_DENOM_EPS, PLANE_T_EPS, SPHERE_EPS, TRI_DET_EPS, TRI_T_EPS,
)

NODE_COLS = 12
PAIR_COLS = 16
PRIM_COLS = 16
COUNT_KEYS = ("visits", "interior", "boxes", "spheres", "planes", "triangles", "fallback_lanes")
# The deepest tree the kernels take: a thread's stack holds one entry a
# level, at most the reference's TRAVERSAL_STACK_DEPTH (the builders
# refuse deeper trees; the wrappers raise on one).
MAX_DEPTH = TRAVERSAL_STACK_DEPTH
# A leaf child's reference packs its first slot and count: ~(slot << 3 | count).
LEAF_COUNT_BITS = 3
MAX_SLOTS = 1 << 28


@dataclasses.dataclass
class DeviceBVH:
    nodes: torch.Tensor  # (K, NODE_COLS) f32 node rows
    prims: torch.Tensor  # (R, PRIM_COLS) f32 leaf rows in slot order
    prim_type: torch.Tensor  # (R,) i32 0 sphere / 1 plane / 2 triangle
    prim_index: torch.Tensor  # (R,) i32 into the scene's arrays of that kind
    small: torch.Tensor  # flat f32 sphere and plane rows (pack_rows) of the fallback
    max_leaf: int
    depth: int
    pairs: torch.Tensor  # (I, PAIR_COLS) f32 child-pair rows of the interior nodes
    root: int  # the root's reference: pair row 0, or a leaf's packed slots

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]


def _as_f32(a):
    return np.ascontiguousarray(a, np.int32).view(np.float32)


def node_table(bvh: FlatBVH) -> np.ndarray:
    """(K, NODE_COLS) f32 node rows: min xyz, payload | max xyz, count |
    axis, 0, 0, 0; the integers bit-cast into float lanes."""
    k = bvh.num_nodes
    rows = np.zeros((k, NODE_COLS), np.float32)
    rows[:, 0:3] = bvh.nodes_min
    rows[:, 4:7] = bvh.nodes_max
    rows[:, 3] = _as_f32(bvh.node_payload)
    rows[:, 7] = _as_f32(bvh.node_count)
    rows[:, 8] = _as_f32(bvh.node_axis)
    return rows


def pair_table(bvh: FlatBVH) -> tuple[np.ndarray, int]:
    """(I, PAIR_COLS) f32 child-pair rows, one an interior node in node
    order, and the root's reference. A row: the first child's (node + 1)
    min xyz, its reference | its max xyz, the second child's (payload)
    reference | the second child's min xyz, the split axis | its max xyz,
    0; box floats copied bit for bit, integers bit-cast. A reference is
    the child's row, or for a leaf ~(first slot << 3 | count)."""
    count = np.asarray(bvh.node_count, np.int64)
    payload = np.asarray(bvh.node_payload, np.int64)
    leaf = count > 0
    if count.max(initial=0) >= 1 << LEAF_COUNT_BITS or payload[leaf].max(initial=0) + count.max(initial=0) > MAX_SLOTS:
        raise ValueError("the tree's leaves do not fit the child-pair references")
    interior = np.nonzero(~leaf)[0]
    row_of = np.zeros(count.shape[0], np.int64)
    row_of[interior] = np.arange(interior.shape[0])

    def ref(node):
        return np.where(leaf[node], ~((payload[node] << LEAF_COUNT_BITS) | count[node]), row_of[node])

    first, second = interior + 1, payload[interior]
    rows = np.zeros((interior.shape[0], PAIR_COLS), np.float32)
    rows[:, 0:3] = bvh.nodes_min[first]
    rows[:, 3] = _as_f32(ref(first))
    rows[:, 4:7] = bvh.nodes_max[first]
    rows[:, 7] = _as_f32(ref(second))
    rows[:, 8:11] = bvh.nodes_min[second]
    rows[:, 11] = _as_f32(bvh.node_axis[interior])
    rows[:, 12:15] = bvh.nodes_max[second]
    return rows, int(ref(np.zeros(1, np.int64))[0])


def prim_table(scene, bvh: FlatBVH) -> torch.Tensor:
    """(R, PRIM_COLS) f32 leaf rows in slot order (the reference's
    _prim_table): the columns by the slot's type, column 15 its bit-cast
    type tag."""
    dev = scene.device
    ptype = torch.from_numpy(np.ascontiguousarray(bvh.prim_type, np.int32)).to(dev)
    pidx = torch.from_numpy(np.ascontiguousarray(bvh.prim_index, np.int64)).to(dev)
    r = ptype.shape[0]
    rows = torch.zeros((r, PRIM_COLS), dtype=torch.float32, device=dev)
    for kind, parts in (
        (0, (scene.sph_pos, scene.sph_radius)),
        (1, (scene.pln_pos, scene.pln_normal, scene.pln_bcm)),
        (2, (scene.tri_a, scene.tri_edge0, scene.tri_edge1)),
    ):
        sel = torch.nonzero(ptype == kind).squeeze(1)
        if sel.numel():
            idx = pidx.index_select(0, sel)
            body = torch.cat([p.index_select(0, idx).reshape(sel.shape[0], -1) for p in parts], dim=1)
            rows[sel, : body.shape[1]] = body.to(torch.float32)
    rows[:, 15] = ptype.view(torch.float32)
    return rows.contiguous()


def device_bvh(bvh: FlatBVH, scene) -> DeviceBVH:
    """Upload a FlatBVH for `scene` (a DeviceScene whose primitive order is
    the host scene's: build_device_scene does not Morton-reorder a scene
    that carries a BVH), on the scene's device."""
    from rsoderh_raytracing_tpu_torch.scene.device import pack_rows  # scene.device imports this module

    dev = scene.device

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    pairs, root = pair_table(bvh)
    return DeviceBVH(
        nodes=up(node_table(bvh)),
        prims=prim_table(scene, bvh),
        prim_type=up(np.asarray(bvh.prim_type, np.int32)),
        prim_index=up(np.asarray(bvh.prim_index, np.int32)),
        small=pack_rows(scene, spheres=True, triangles=False, materials=False),
        max_leaf=int(bvh.node_count.max()),
        depth=int(bvh.depth),
        pairs=up(pairs),
        root=root,
    )


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def slab(o, inv, lo, hi):
    """(hit, entry t0) of rays (origins o, reciprocal directions inv:
    3-tuples of (m,)) against boxes lo, hi ((m, 3) or (1, 3)): per axis
    the NaN-propagating min/max of the two slab times, a NaN axis
    ignored (entry 0, exit 3e38), t0 = max(axes' entries clamped at 0),
    t1 = min(axes' exits), hit = t0 <= t1 (geometry.ray_bounds_entry)."""
    t0 = t1 = None
    for a in range(3):
        near = (lo[:, a] - o[a]) * inv[a]
        far = (hi[:, a] - o[a]) * inv[a]
        t_lo, t_hi = torch.minimum(near, far), torch.maximum(near, far)
        t_lo = torch.where(torch.isnan(t_lo), 0.0, torch.clamp_min(t_lo, 0.0))
        t_hi = torch.where(torch.isnan(t_hi), INF, t_hi)
        t0 = t_lo if t0 is None else torch.maximum(t0, t_lo)
        t1 = t_hi if t1 is None else torch.minimum(t1, t_hi)
    return t0 <= t1, t0


def _sphere_t(o, d, row):
    center, radius = (row[:, 0], row[:, 1], row[:, 2]), row[:, 3]
    lv = _sub(o, center)
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
    return torch.where((disc >= 0.0) & (t >= SPHERE_EPS), t, INF)


def _plane_t(o, d, row):
    pos, normal = (row[:, 0], row[:, 1], row[:, 2]), (row[:, 3], row[:, 4], row[:, 5])
    denom = _dot(normal, d)
    ok = torch.abs(denom) >= PLANE_DENOM_EPS
    t = _dot(normal, _sub(pos, o)) / torch.where(ok, denom, 1.0)
    inter = tuple(o[k] + d[k] * t - pos[k] for k in range(3))
    x = _dot((row[:, 6], row[:, 7], row[:, 8]), inter)
    z = _dot((row[:, 12], row[:, 13], row[:, 14]), inter)
    hit = ok & (t >= PLANE_T_EPS) & (x >= 0) & (x <= 1) & (z >= 0) & (z <= 1)
    return torch.where(hit, t, INF)


def _triangle_t(o, d, row):
    a = (row[:, 0], row[:, 1], row[:, 2])
    e0 = (row[:, 3], row[:, 4], row[:, 5])
    e1 = (row[:, 6], row[:, 7], row[:, 8])
    rel = _sub(o, a)
    p0 = _cross(rel, e0)
    p1 = _cross(d, e1)
    det = _dot(e0, p1)
    ok = torch.abs(det) >= TRI_DET_EPS
    inv = 1.0 / torch.where(ok, det, 1.0)
    u = _dot(rel, p1) * inv
    v = _dot(d, p0) * inv
    t = _dot(e1, p0) * inv
    hit = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= TRI_T_EPS)
    return torch.where(hit, t, INF)


_LEAF_TESTS = ((0, "spheres", _sphere_t), (1, "planes", _plane_t), (2, "triangles", _triangle_t))


def _walk(bvh: DeviceBVH, ro, rd, lanes, closest, counts):
    """The reference's walk for the lanes `lanes` (int64 indices). Returns
    (best_t, best_slot) for closest, else the occluded bools, over every
    lane (the others: INF, -1 / False)."""
    n = ro[0].shape[0]
    dev = ro[0].device
    best_t = torch.full((n,), INF, device=dev)
    best_slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    occluded = torch.zeros(n, dtype=torch.bool, device=dev)
    nodes_i = bvh.nodes.view(torch.int32)
    prims_i = bvh.prims.view(torch.int32)
    inv = tuple(1.0 / c for c in rd)
    n_prims = bvh.prims.shape[0]

    def at(vec, idx):
        return tuple(c.index_select(0, idx) for c in vec)

    root = bvh.nodes[0:1]
    hit, _ = slab(at(ro, lanes), at(inv, lanes), root[:, 0:3], root[:, 4:7])
    counts["boxes"] += int(lanes.numel())
    lanes = lanes[hit]
    m = lanes.shape[0]
    depth = TRAVERSAL_STACK_DEPTH
    stack = torch.zeros((m, depth), dtype=torch.int64, device=dev)
    tstack = torch.zeros((m, depth), dtype=torch.float32, device=dev)
    sp = torch.zeros(m, dtype=torch.int64, device=dev)
    cur = torch.zeros(m, dtype=torch.int64, device=dev)
    cur_entry = torch.zeros(m, dtype=torch.float32, device=dev)
    act = torch.arange(m, device=dev)
    while act.numel():
        counts["visits"] += int(act.numel())
        lane = lanes.index_select(0, act)
        node = cur.index_select(0, act)
        meta = nodes_i.index_select(0, node)
        payload, count, axis = meta[:, 3].long(), meta[:, 7].long(), meta[:, 8].long()
        alive = torch.ones_like(lane, dtype=torch.bool)
        if closest:
            alive = cur_entry.index_select(0, act) <= best_t.index_select(0, lane)
        found = torch.zeros_like(alive)

        li = torch.nonzero(alive & (count > 0)).squeeze(1)
        if li.numel():
            leaf_lane = lane.index_select(0, li)
            o, d = at(ro, leaf_lane), at(rd, leaf_lane)
            start, cnt = payload.index_select(0, li), count.index_select(0, li)
            lt = torch.full((li.shape[0],), INF, device=dev)
            ls = torch.full((li.shape[0],), -1, dtype=torch.int64, device=dev)
            for j in range(int(cnt.max())):
                slot = torch.clamp_max(start + j, n_prims - 1)
                tested = (j < cnt) & (closest | (lt >= INF))
                row = bvh.prims.index_select(0, slot)
                ptype = prims_i.index_select(0, slot)[:, 15]
                t = torch.full_like(lt, INF)
                for kind, key, test in _LEAF_TESTS:
                    is_kind = ptype == kind
                    counts[key] += int((is_kind & tested).sum())
                    if bool(is_kind.any()):
                        t = torch.where(is_kind, test(o, d, row), t)
                t = torch.where(j < cnt, t, INF)
                better = t < lt
                lt = torch.where(better, t, lt)
                ls = torch.where(better, slot, ls)
            if closest:
                better = lt < best_t.index_select(0, leaf_lane)
                best_t[leaf_lane] = torch.where(better, lt, best_t.index_select(0, leaf_lane))
                best_slot[leaf_lane] = torch.where(
                    better, ls.to(torch.int32), best_slot.index_select(0, leaf_lane))
            else:
                hit_leaf = lt < INF
                found[li] = hit_leaf
                occluded[leaf_lane[hit_leaf]] = True

        has_child = torch.zeros_like(alive)
        descend = node.clone()
        descend_entry = cur_entry.index_select(0, act)
        ii = torch.nonzero(alive & (count == 0)).squeeze(1)
        if ii.numel():
            int_lane = lane.index_select(0, ii)
            o, iv = at(ro, int_lane), at(inv, int_lane)
            ax = axis.index_select(0, ii)
            neg = torch.where(ax == 0, iv[0], torch.where(ax == 1, iv[1], iv[2])) < 0.0
            here, second = node.index_select(0, ii), payload.index_select(0, ii)
            near = torch.where(neg, second, here + 1)
            far = torch.where(neg, here + 1, second)
            n_row, f_row = bvh.nodes.index_select(0, near), bvh.nodes.index_select(0, far)
            hit_n, n_entry = slab(o, iv, n_row[:, 0:3], n_row[:, 4:7])
            hit_f, f_entry = slab(o, iv, f_row[:, 0:3], f_row[:, 4:7])
            counts["boxes"] += 2 * int(ii.numel())
            counts["interior"] += int(ii.numel())
            if closest:
                bt = best_t.index_select(0, int_lane)
                hit_n = hit_n & (n_entry <= bt)
                hit_f = hit_f & (f_entry <= bt)
            push = hit_n & hit_f
            pos = act.index_select(0, ii)[push]
            k = torch.clamp(sp.index_select(0, pos), 0, depth - 1)
            stack[pos, k] = far[push]
            tstack[pos, k] = f_entry[push]
            sp[pos] += 1
            has_child[ii] = hit_n | hit_f
            descend[ii] = torch.where(hit_n, near, far)
            descend_entry[ii] = torch.where(hit_n, n_entry, f_entry)

        sp_act = sp.index_select(0, act)
        pop = ~has_child & ~found & (sp_act > 0)
        k = torch.clamp(sp_act - 1, 0, depth - 1)
        popped = stack[act, k]
        popped_entry = tstack[act, k]
        cur[act] = torch.where(has_child, descend, torch.where(pop, popped, node))
        cur_entry[act] = torch.where(
            has_child, descend_entry, torch.where(pop, popped_entry, cur_entry.index_select(0, act)))
        sp[act] = torch.where(pop, sp_act - 1, sp_act)
        act = act[has_child | pop]
    return (best_t, best_slot) if closest else occluded


def _lanes(ro, mask):
    if mask is None:
        return torch.arange(ro[0].shape[0], device=ro[0].device)
    return torch.nonzero(mask != 0).squeeze(1)


def _counts(counts):
    out = {k: 0 for k in COUNT_KEYS}
    if counts is not None:
        counts.update(out)
        return counts
    return out


def traverse_closest(bvh: DeviceBVH, ro, rd, live=None, counts=None):
    """Closest (t, slot) of rays (ro, rd: 3-tuples of (n,) f32) by the
    walk of the reference's traverse_closest, for lanes with live != 0
    (every lane when live is None); a miss, or a lane off the mask, is
    (3e38, -1). `counts`, a dict, gets the walk's COUNT_KEYS. The leaf
    rows are bvh.prims (the reference's walk takes the scene for them)."""
    return _walk(bvh, ro, rd, _lanes(ro, live), True, _counts(counts))


def traverse_any(bvh: DeviceBVH, ro, rd, mask=None, counts=None):
    """(n,) bool: the walk of the reference's traverse_any finds a hit, for
    lanes with mask != 0 (every lane when mask is None); it stops at a
    lane's first hit. Equal to traverse_closest's slot >= 0."""
    return _walk(bvh, ro, rd, _lanes(ro, mask), False, _counts(counts))


def closest_plain(scene, ro, rd, live, counts=None, *, fallback_lanes=None):
    """BVH_CLOSEST's plain twin: (t f32, type i32, index i32) of the walk,
    and on a BVH miss of the linear sphere and plane sweep
    (intersect._sweep_bvh) over the valid rows (scene.sweep_rows); lanes
    with live == 0 hold (3e38, -1, 0). fallback_lanes, an int64 scalar
    tensor, gets the number of lanes the sweep took added in place, as
    the kernel's fallback pass adds it."""
    from rsoderh_raytracing_tpu_torch.ops import intersect

    bvh = scene.bvh
    counts = _counts(counts)
    t, slot = traverse_closest(bvh, ro, rd, live, counts)
    hit = slot >= 0
    safe = torch.where(hit, slot, 0).long()
    ptype = torch.where(hit, bvh.prim_type.index_select(0, safe), -1).to(torch.int32)
    pidx = torch.where(hit, bvh.prim_index.index_select(0, safe), 0).to(torch.int32)
    miss = torch.nonzero(~hit & (live != 0)).squeeze(1)
    counts["fallback_lanes"] += int(miss.numel())
    if fallback_lanes is not None:
        fallback_lanes.add_(int(miss.numel()))
    if miss.numel():
        rays = tuple(c.index_select(0, miss) for c in (*ro, *rd))
        fb = intersect._sweep(scene, rays, (intersect.SPHERE, intersect.PLANE), scene.sweep_rows)
        for full, part in zip((t, ptype, pidx), fb):
            full.index_copy_(0, miss, part)
    return t, ptype, pidx


def any_plain(scene, ro, rd, t, ptype, in_path, nee_dir, counts=None):
    """BVH_ANY's plain twin: occlusion (i32 0/1) by the walk of the shadow
    rays from the closest hit (t, type) of rays (ro, rd) along nee_dir
    (intersect.shadow_origins), for lanes in a path whose ray hit; 0 on the
    others."""
    from rsoderh_raytracing_tpu_torch.ops import intersect

    p, mask = intersect.shadow_origins(ro, rd, t, ptype, in_path)
    return traverse_any(scene.bvh, p, nee_dir, mask, counts).to(torch.int32)


def walk_model(bvh: DeviceBVH, ro, rd, mask, closest, counts=None):
    """A plain walk over the child-pair rows, each ray's as the kernels
    walk it: the lanes with mask != 0 whose ray enters the root's box (a
    box test each), in lane order, from bvh.root; both children's boxes
    from one row, a leaf child's slots from its reference, popping past
    entries whose entry time is beyond the best t (closest). Returns what
    traverse_closest (closest) or traverse_any returns, and adds the same
    counts."""
    counts = _counts(counts)
    n = ro[0].shape[0]
    dev = ro[0].device
    lanes = _lanes(ro, mask)
    counts["boxes"] += int(lanes.numel())
    root = bvh.nodes[0:1]
    enters, _ = slab(tuple(c.index_select(0, lanes) for c in ro),
                     tuple(1.0 / c.index_select(0, lanes) for c in rd), root[:, 0:3], root[:, 4:7])
    lanes = lanes[enters]
    m = lanes.numel()
    o = tuple(c.index_select(0, lanes) for c in ro)
    d = tuple(c.index_select(0, lanes) for c in rd)
    inv = tuple(1.0 / c for c in d)
    pairs_i = bvh.pairs.view(torch.int32)
    prims_i = bvh.prims.view(torch.int32)
    depth = TRAVERSAL_STACK_DEPTH
    stack = torch.zeros((m, depth), dtype=torch.int64, device=dev)
    tstack = torch.zeros((m, depth), dtype=torch.float32, device=dev)
    sp = torch.zeros(m, dtype=torch.int64, device=dev)
    cur = torch.full((m,), bvh.root, dtype=torch.int64, device=dev)
    best_t = torch.full((m,), INF, device=dev)
    best_slot = torch.full((m,), -1, dtype=torch.int64, device=dev)
    running = torch.ones(m, dtype=torch.bool, device=dev)

    def at(vec, idx):
        return tuple(c.index_select(0, idx) for c in vec)

    while bool(running.any()):
        act = torch.nonzero(running).squeeze(1)
        node = cur.index_select(0, act)
        counts["visits"] += int(act.numel())
        need_pop = torch.zeros(m, dtype=torch.bool, device=dev)

        ii = act[node >= 0]
        if ii.numel():
            counts["interior"] += int(ii.numel())
            counts["boxes"] += 2 * int(ii.numel())
            row, row_i = bvh.pairs.index_select(0, cur[ii]), pairs_i.index_select(0, cur[ii])
            oi, iv = at(o, ii), at(inv, ii)
            hit_l, entry_l = slab(oi, iv, row[:, 0:3], row[:, 4:7])
            hit_r, entry_r = slab(oi, iv, row[:, 8:11], row[:, 12:15])
            ax = row_i[:, 11].long()
            neg = torch.where(ax == 0, iv[0], torch.where(ax == 1, iv[1], iv[2])) < 0.0
            ref_l, ref_r = row_i[:, 3].long(), row_i[:, 7].long()
            near, far = torch.where(neg, ref_r, ref_l), torch.where(neg, ref_l, ref_r)
            hit_n, hit_f = torch.where(neg, hit_r, hit_l), torch.where(neg, hit_l, hit_r)
            n_entry, f_entry = torch.where(neg, entry_r, entry_l), torch.where(neg, entry_l, entry_r)
            if closest:
                bt = best_t.index_select(0, ii)
                hit_n, hit_f = hit_n & (n_entry <= bt), hit_f & (f_entry <= bt)
            push = hit_n & hit_f
            pos = ii[push]
            k = torch.clamp(sp.index_select(0, pos), max=depth - 1)
            stack[pos, k], tstack[pos, k] = far[push], f_entry[push]
            sp[pos] += 1
            child = hit_n | hit_f
            cur[ii[child]] = torch.where(hit_n, near, far)[child]
            need_pop[ii[~child]] = True

        li = act[node < 0]
        if li.numel():
            packed = ~cur.index_select(0, li)
            first, cnt = packed >> LEAF_COUNT_BITS, packed & ((1 << LEAF_COUNT_BITS) - 1)
            ol, dl = at(o, li), at(d, li)
            found = torch.zeros(li.shape[0], dtype=torch.bool, device=dev)
            for j in range(int(cnt.max())):
                tested = (j < cnt) & ~found
                slot = torch.where(tested, first + j, 0)
                row = bvh.prims.index_select(0, slot)
                ptype = prims_i.index_select(0, slot)[:, 15]
                t = torch.full((li.shape[0],), INF, device=dev)
                for kind, key, test in _LEAF_TESTS:
                    is_kind = ptype == kind
                    counts[key] += int((is_kind & tested).sum())
                    if bool((is_kind & tested).any()):
                        t = torch.where(is_kind, test(ol, dl, row), t)
                better = tested & (t < best_t.index_select(0, li))
                best_t[li[better]] = t[better]
                best_slot[li[better]] = slot[better]
                if not closest:
                    found |= better
            running[li[found]] = False
            need_pop[li[~found]] = True

        # pop; closest skips the entries entered past the best t, a visit each
        while bool(need_pop.any()):
            pi = torch.nonzero(need_pop).squeeze(1)
            empty = sp.index_select(0, pi) == 0
            running[pi[empty]] = False
            pi = pi[~empty]
            sp[pi] -= 1
            k = torch.clamp(sp.index_select(0, pi), max=depth - 1)
            cur[pi] = stack[pi, k]
            need_pop[:] = False
            if closest:
                pruned = tstack[pi, k] > best_t.index_select(0, pi)
                counts["visits"] += int(pruned.sum())
                need_pop[pi[pruned]] = True

    out_t = torch.full((n,), INF, device=dev)
    out_slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    out_t[lanes] = best_t
    out_slot[lanes] = best_slot.to(torch.int32)
    return (out_t, out_slot) if closest else out_slot >= 0
