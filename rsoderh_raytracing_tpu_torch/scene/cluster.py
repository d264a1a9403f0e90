"""Triangle orders of the chunked route, derived from the SAH BVH.

A copy of rsoderh_raytracing_tpu/scene/cluster.py (pure numpy, no torch):
the same orders, pad rows and valid masks, bit for bit
(tests/test_torch_cluster.py). The chunked kernels (csrc/chunked.cu)
sweep triangles in windows of TRI_CHUNK rows and cull a whole window by
its AABB, so the tighter a window's box, the fewer (lane, chunk) pairs
they sweep. The default order is a Morton sort of the centroids
(scene/device.py); this module derives two others from the SAH BVH of
the triangles (accel/bvh.py, its native builder where g++ is available):

- ``bvh_dfs_order``: the triangles in the BVH's depth-first leaf order, a
  permutation like the Morton sort: consecutive windows follow the SAH
  partition instead of a space-filling curve.
- ``treelet_pack``: the BVH cut into maximal subtrees of at most
  TRI_CHUNK triangles, DFS-adjacent cuts packed greedily into chunks of
  TRI_CHUNK rows, each chunk padded to exactly TRI_CHUNK rows. A pad row
  collapses to the chunk's first real triangle's v0 (a = b = c): every
  intersection constant is zero, so det == 0 and the |det| gate makes it
  unhittable, and its valid flag is 0; the collapsed vertex keeps the
  chunk's box tight.

Selection: RT_CHUNK_CLUSTER=morton|bvh|treelet (scene/device.py). Both
are storage-order changes: the closest hit is a minimum over the same
triangles, so images are equal but for exact-t ties.

Unlike the reference, the per-node sweeps (_subtree_counts,
_leaf_ranges) run level by level in numpy rather than node by node in
Python, and treelet_pack refuses a chunk that a BVH leaf may not fit.
"""

from __future__ import annotations

import numpy as np

from rsoderh_raytracing_tpu_torch.accel.bvh import MAX_PRIMITIVES_PER_LEAF, build_bvh_from_bounds


def _tri_bvh(vertices: np.ndarray, tris: np.ndarray):
    """SAH BVH over the triangles alone (bounds from the three corners)."""
    pts = np.stack(
        [vertices[tris[:, 0]], vertices[tris[:, 1]], vertices[tris[:, 2]]],
        axis=1,
    )
    mins = pts.min(axis=1).astype(np.float32)
    maxs = pts.max(axis=1).astype(np.float32)
    n = len(tris)
    return build_bvh_from_bounds(
        mins,
        maxs,
        np.full(n, 2, np.int32),
        np.arange(n, dtype=np.int32),
    )


def bvh_dfs_order(vertices: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Permutation putting triangles in SAH-BVH depth-first leaf order."""
    return _tri_bvh(vertices, tris).source_order


def _levels(payload: np.ndarray, count: np.ndarray):
    """The nodes of the flat DFS-preorder BVH by depth, root first: an
    interior node k has its children at k + 1 and payload[k], one level
    down."""
    if len(payload) == 0:
        return []
    levels = []
    frontier = np.zeros(1, np.int64)
    while frontier.size:
        levels.append(frontier)
        inner = frontier[count[frontier] == 0]
        frontier = np.concatenate([inner + 1, payload[inner].astype(np.int64)])
    return levels


def _subtree_counts(payload: np.ndarray, count: np.ndarray) -> np.ndarray:
    """Per-node primitive counts: a leaf's own, an interior node's the sum
    of its children's, the deepest level first."""
    out = np.zeros(len(payload), np.int64)
    for nodes in reversed(_levels(payload, count)):
        leaf = count[nodes] > 0
        out[nodes[leaf]] = count[nodes[leaf]]
        inner = nodes[~leaf]
        out[inner] = out[inner + 1] + out[payload[inner]]
    return out


def _leaf_ranges(payload: np.ndarray, count: np.ndarray):
    """Per-node ordered-primitive range [lo, hi): leaves emit consecutive
    runs in DFS preorder, so every subtree's range is contiguous."""
    n = len(payload)
    lo = np.full(n, np.iinfo(np.int64).max)
    hi = np.zeros(n, np.int64)
    for nodes in reversed(_levels(payload, count)):
        leaf = nodes[count[nodes] > 0]
        lo[leaf] = payload[leaf]
        hi[leaf] = payload[leaf] + count[leaf]
        inner = nodes[count[nodes] == 0]
        lo[inner] = np.minimum(lo[inner + 1], lo[payload[inner]])
        hi[inner] = np.maximum(hi[inner + 1], hi[payload[inner]])
    return lo, hi


def treelet_cuts(payload: np.ndarray, count: np.ndarray, cap: int):
    """Maximal subtree cuts with <= cap primitives, in DFS order."""
    counts = _subtree_counts(payload, count)
    cuts = []
    stack = [0]
    while stack:
        k = stack.pop()
        if count[k] > 0 or counts[k] <= cap:
            cuts.append(k)
        else:
            # push right then left so the left child pops first
            stack.append(int(payload[k]))
            stack.append(k + 1)
    return cuts, counts


def treelet_pack(
    vertices: np.ndarray, tris: np.ndarray, chunk: int
) -> "tuple[np.ndarray, np.ndarray]":
    """Reorder + pad `tris` so every `chunk`-row window is a union of
    few DFS-adjacent SAH subtrees. Returns (tris_out, valid) where
    tris_out has a multiple-of-`chunk` row count and valid marks the
    real (non-pad) rows. Raises ValueError for a chunk smaller than a
    BVH leaf may be."""
    if chunk < MAX_PRIMITIVES_PER_LEAF:
        raise ValueError(
            f"treelet_pack: chunk {chunk} is smaller than a BVH leaf may be "
            f"({MAX_PRIMITIVES_PER_LEAF} primitives)"
        )
    bvh = _tri_bvh(vertices, tris)
    cuts, counts = treelet_cuts(bvh.node_payload, bvh.node_count, chunk)
    too_big = [k for k in cuts if counts[k] > chunk]
    if too_big:
        raise ValueError(
            f"treelet_pack: a cut of {int(counts[too_big[0]])} triangles does not fit "
            f"a chunk of {chunk} rows"
        )
    lo, hi = _leaf_ranges(bvh.node_payload, bvh.node_count)
    order = bvh.source_order

    # Greedy sequential pack of DFS-adjacent cuts into chunk-capacity
    # groups (DFS adjacency == spatial adjacency under the SAH
    # partition, so merged cuts stay compact).
    groups: "list[list[int]]" = [[]]
    fill = 0
    for k in cuts:
        c = int(counts[k])
        if fill + c > chunk and fill:
            groups.append([])
            fill = 0
        groups[-1].append(k)
        fill += c

    rows = []
    valid = []
    for g in groups:
        n = 0
        for k in g:
            rows.append(tris[order[lo[k]: hi[k]]])
            n += int(hi[k] - lo[k])
        pad = chunk - n
        if pad:
            first = tris[order[lo[g[0]]]]
            padrow = np.array(
                [first[0]] * 3 + [first[3]] * 3 + [first[6]],
                dtype=tris.dtype,
            )
            rows.append(np.tile(padrow, (pad, 1)))
        valid.append(np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]))
    return np.concatenate(rows, axis=0), np.concatenate(valid)
