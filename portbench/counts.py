"""What a kernel's inputs need: the operations and bytes of one captured
iteration, from which stats.least_seconds gives the roofline's least time.

The counts follow the algorithm the port runs today; a change of that
algorithm needs the benchmark to count again.

- TRACE (small route): every lane's ray and state in (7 words) and its 26
  outputs and quad row out, an alias row and a quad row read; the live
  lanes' closest sweep over every valid row (no padding), and the live
  lanes that hit their occlusion sweep over the valid rows in sweep order
  up to the first hit.
- BVH_CLOSEST and BVH_ANY (BVH route): every lane's 7 input words and 3
  (or 1) outputs and the tables once; the node visits' box tests and the
  leaf tests that a walk of the tree the program walks makes (a frozen
  copy of the reference's walk in the port's ops/bvh.py: best-t pruning,
  both children tested at the parent, the near child first, leaf slots in
  order), and BVH_CLOSEST's fallback sweep over the valid sphere and plane
  rows of the lanes the walk missed.

Operations of one test are counted by hand from the kernels' source
(csrc/wavefront_common.cuh, csrc/bvh.cu), as the port's profiling.py
counts them: every add, multiply, divide, square root, compare, min/max
and select is one.
"""

from __future__ import annotations

import torch

from portbench.reference import envmap, rng
from portbench.reference.intersect import INF, PLANE, SPHERE, TRIANGLE, TESTS, _terms, closest

OPS_SPHERE = 38
OPS_PLANE = 33
OPS_TRIANGLE = 47
OPS_BOX = 39
OPS_LEAF = {"spheres": 49, "planes": 48, "triangles": 61}
TRACE_WORDS_IN = 7
TRACE_WORDS_OUT = 26
STACK_DEPTH = 64
BLOCK = 1 << 20


def _nee_dir(carry, env):
    """The NEE direction TRACE's alias draw gives each lane."""
    state = rng.from_bits(carry["state"])
    _, _, u, v, _ = envmap.sample_alias_index(state, env)
    return envmap.equirect_uv_to_direction(u, v)


def trace_counts(carry, ref_scene, env):
    """(bytes, operations) of one TRACE launch on the captured carry."""
    n = carry["state"].shape[0]
    n_sph, n_pln, n_tri = (ref_scene.sph_radius.shape[0], ref_scene.pln_ndotp.shape[0],
                           ref_scene.tri_adotn.shape[0])
    live = torch.nonzero(carry["in_path"] != 0).squeeze(1)
    ro = tuple(carry[f"ro{i}"] for i in range(3))
    rd = tuple(carry[f"rd{i}"] for i in range(3))
    nd = _nee_dir(carry, env)
    ops = live.shape[0] * (n_sph * OPS_SPHERE + n_pln * OPS_PLANE + n_tri * OPS_TRIANGLE)
    tests = {SPHERE: OPS_SPHERE, PLANE: OPS_PLANE, TRIANGLE: OPS_TRIANGLE}
    for s in range(0, live.shape[0], BLOCK):
        lanes = live[s:s + BLOCK]
        o, d = tuple(c[lanes] for c in ro), tuple(c[lanes] for c in rd)
        t, ptype, _ = closest(ref_scene, o, d, "expanded")
        hit = torch.nonzero(ptype >= 0).squeeze(1)
        p = tuple(o[k][hit] + d[k][hit] * t[hit] for k in range(3))
        r = _terms(p, tuple(c[lanes][hit] for c in nd))
        done = torch.zeros(hit.shape[0], dtype=torch.bool, device=hit.device)
        for kind, op in tests.items():
            count = (n_sph, n_pln, n_tri)[kind]
            if count == 0:
                continue
            rows = torch.arange(count, device=hit.device)[None, :].expand(hit.shape[0], count)
            hits = TESTS["expanded"][kind](ref_scene, r, rows)[1]
            first = torch.where(hits.any(dim=1), hits.to(torch.int8).argmax(dim=1) + 1, count)
            ops += int(torch.where(done, 0, first).sum()) * op
            done |= hits.any(dim=1)
    n_bytes = n * 4 * (TRACE_WORDS_IN + TRACE_WORDS_OUT) + n * 16 * 3
    return n_bytes, ops


def _walk(bvh, ro, rd, lanes, closest_walk, counts):
    """The walk of the lanes `lanes` over the program's tree tables
    (bvh.nodes, bvh.prims); counts node visits, box tests, interior visits
    and leaf tests by kind. Returns (best_t, slot) or occluded bools."""
    n = ro[0].shape[0]
    dev = ro[0].device
    best_t = torch.full((n,), INF, device=dev)
    occluded = torch.zeros(n, dtype=torch.bool, device=dev)
    nodes_i = bvh.nodes.view(torch.int32)
    prims_i = bvh.prims.view(torch.int32)
    inv = tuple(1.0 / c for c in rd)
    n_prims = bvh.prims.shape[0]

    def at(vec, idx):
        return tuple(c.index_select(0, idx) for c in vec)

    def slab(o, iv, lo, hi):
        t0 = t1 = None
        for a in range(3):
            near, far = (lo[:, a] - o[a]) * iv[a], (hi[:, a] - o[a]) * iv[a]
            t_lo, t_hi = torch.minimum(near, far), torch.maximum(near, far)
            t_lo = torch.where(torch.isnan(t_lo), 0.0, torch.clamp_min(t_lo, 0.0))
            t_hi = torch.where(torch.isnan(t_hi), INF, t_hi)
            t0 = t_lo if t0 is None else torch.maximum(t0, t_lo)
            t1 = t_hi if t1 is None else torch.minimum(t1, t_hi)
        return t0 <= t1, t0

    def leaf(kind, o, d, row):
        # the leaf row's columns as the scene fields the tests read
        if kind == SPHERE:
            s = _RowScene(sph_pos=row[:, 0:3], sph_radius=row[:, 3])
        elif kind == PLANE:
            s = _RowScene(pln_pos=row[:, 0:3], pln_normal=row[:, 3:6], pln_r0=row[:, 6:9], pln_r2=row[:, 12:15])
        else:
            s = _RowScene(tri_a=row[:, 0:3], tri_edge0=row[:, 3:6], tri_edge1=row[:, 6:9])
        idx = torch.arange(row.shape[0], device=dev)[:, None]
        t, hit = TESTS["direct"][kind](s, dict(o=tuple(c[:, None] for c in o), d=tuple(c[:, None] for c in d)), idx)
        return torch.where(hit, t, INF)[:, 0]

    root = bvh.nodes[0:1]
    hit, _ = slab(at(ro, lanes), at(inv, lanes), root[:, 0:3], root[:, 4:7])
    counts["boxes"] += int(lanes.numel())
    lanes = lanes[hit]
    m = lanes.shape[0]
    stack = torch.zeros((m, STACK_DEPTH), dtype=torch.int64, device=dev)
    tstack = torch.zeros((m, STACK_DEPTH), dtype=torch.float32, device=dev)
    sp = torch.zeros(m, dtype=torch.int64, device=dev)
    cur = torch.zeros(m, dtype=torch.int64, device=dev)
    cur_entry = torch.zeros(m, dtype=torch.float32, device=dev)
    act = torch.arange(m, device=dev)
    kinds = ((SPHERE, "spheres"), (PLANE, "planes"), (TRIANGLE, "triangles"))
    while act.numel():
        counts["visits"] += int(act.numel())
        lane = lanes.index_select(0, act)
        node = cur.index_select(0, act)
        meta = nodes_i.index_select(0, node)
        payload, count, axis = meta[:, 3].long(), meta[:, 7].long(), meta[:, 8].long()
        alive = torch.ones_like(lane, dtype=torch.bool)
        if closest_walk:
            alive = cur_entry.index_select(0, act) <= best_t.index_select(0, lane)
        found = torch.zeros_like(alive)
        li = torch.nonzero(alive & (count > 0)).squeeze(1)
        if li.numel():
            leaf_lane = lane.index_select(0, li)
            o, d = at(ro, leaf_lane), at(rd, leaf_lane)
            start, cnt = payload.index_select(0, li), count.index_select(0, li)
            lt = torch.full((li.shape[0],), INF, device=dev)
            for j in range(int(cnt.max())):
                slot = torch.clamp_max(start + j, n_prims - 1)
                tested = (j < cnt) & (closest_walk | (lt >= INF))
                row = bvh.prims.index_select(0, slot)
                ptype = prims_i.index_select(0, slot)[:, 15]
                t = torch.full_like(lt, INF)
                for kind, key in kinds:
                    is_kind = ptype == kind
                    counts[key] += int((is_kind & tested).sum())
                    if bool(is_kind.any()):
                        t = torch.where(is_kind, leaf(kind, o, d, row), t)
                t = torch.where(j < cnt, t, INF)
                lt = torch.minimum(lt, t)
            if closest_walk:
                best_t[leaf_lane] = torch.minimum(lt, best_t.index_select(0, leaf_lane))
            else:
                found[li] = lt < INF
                occluded[leaf_lane[lt < INF]] = True
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
            if closest_walk:
                bt = best_t.index_select(0, int_lane)
                hit_n, hit_f = hit_n & (n_entry <= bt), hit_f & (f_entry <= bt)
            push = hit_n & hit_f
            pos = act.index_select(0, ii)[push]
            k = torch.clamp(sp.index_select(0, pos), 0, STACK_DEPTH - 1)
            stack[pos, k] = far[push]
            tstack[pos, k] = f_entry[push]
            sp[pos] += 1
            has_child[ii] = hit_n | hit_f
            descend[ii] = torch.where(hit_n, near, far)
            descend_entry[ii] = torch.where(hit_n, n_entry, f_entry)
        sp_act = sp.index_select(0, act)
        pop = ~has_child & ~found & (sp_act > 0)
        k = torch.clamp(sp_act - 1, 0, STACK_DEPTH - 1)
        popped, popped_entry = stack[act, k], tstack[act, k]
        cur[act] = torch.where(has_child, descend, torch.where(pop, popped, node))
        cur_entry[act] = torch.where(has_child, descend_entry,
                                     torch.where(pop, popped_entry, cur_entry.index_select(0, act)))
        sp[act] = torch.where(pop, sp_act - 1, sp_act)
        act = act[has_child | pop]
    return best_t if closest_walk else occluded


class _RowScene:
    def __init__(self, **fields):
        self.__dict__.update(fields)


def bvh_counts(carry, bvh, ref_scene, env):
    """((bytes, operations) of BVH_CLOSEST, (bytes, operations) of
    BVH_ANY, and the walks' counts) on the captured carry."""
    n = carry["state"].shape[0]
    ro = tuple(carry[f"ro{i}"] for i in range(3))
    rd = tuple(carry[f"rd{i}"] for i in range(3))
    live = torch.nonzero(carry["in_path"] != 0).squeeze(1)
    keys = ("visits", "interior", "boxes", "spheres", "planes", "triangles")
    c_counts = dict.fromkeys(keys, 0)
    best_t = _walk(bvh, ro, rd, live, True, c_counts)
    missed = live[best_t[live] >= INF]
    c_counts["fallback_lanes"] = int(missed.numel())
    t = best_t.clone()
    if missed.numel():
        t[missed] = closest(ref_scene, tuple(c[missed] for c in ro), tuple(c[missed] for c in rd),
                            "expanded", (SPHERE, PLANE))[0]
    hit_lanes = live[t[live] < INF]
    p = tuple(ro[k] + rd[k] * torch.where(t < INF, t, 0.0) for k in range(3))
    a_counts = dict.fromkeys(keys, 0)
    _walk(bvh, p, _nee_dir(carry, env), hit_lanes, False, a_counts)
    n_sph, n_pln = ref_scene.sph_radius.shape[0], ref_scene.pln_ndotp.shape[0]
    fallback = n_sph * OPS_SPHERE + n_pln * OPS_PLANE

    def ops(c, with_fallback):
        return (c["boxes"] * OPS_BOX + sum(c[k] * v for k, v in OPS_LEAF.items())
                + (c["fallback_lanes"] * fallback if with_fallback else 0))

    tables = 4 * (8 + bvh.pairs.numel() + bvh.prims.numel())
    closest_bytes = n * 4 * (7 + 3) + tables + 4 * (2 * bvh.prim_type.numel() + bvh.small.numel())
    any_bytes = n * 4 * (7 + 1) + tables
    return (closest_bytes, ops(c_counts, True)), (any_bytes, ops(a_counts, False)), dict(
        closest=c_counts, any=a_counts)
