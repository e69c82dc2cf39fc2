"""SAH BVH build + stackless (threaded) flatten + 6-way MTBVH.

Host-side rebuild of the reference's CPU BVH pipeline
(reference: src/BVH.cpp:13-239, src/BVH.h):

- top-down recursive SAH with BUCKET_NUM=20 centroid buckets on the
  max-extent axis of the centroid bounds, cost
  (nL·SA(L) + nR·SA(R)) / SA(root), in-place partition of the triangle
  array (reference: src/BVH.cpp:13-92)
- leaves hold <= MAX_PRIM = 1 triangle (reference: src/BVH.h:5)
- preorder flatten to parent/left/right info (reference: src/BVH.cpp:121-147)
- threaded linearization: hit = next preorder index, miss = sibling (for a
  left child) or parent's miss (reference: src/BVH.cpp:149-178)
- MTBVH: 6 direction-ordered replicas [+x,+y,+z,-x,-y,-z]; internal nodes'
  hit link points at the NEAR child for that direction, leaf hit/miss use
  sibling-or-parent-miss (reference: src/BVH.cpp:180-239)

Divergence from the reference (documented per SURVEY.md §7): when a SAH
split is degenerate (all centroids in one bucket / zero-extent axis) the
reference can recurse forever; we fall back to a median split.

The build returns a permutation of the input triangles (the reference
partitions its triangle vector in place) plus flat SoA arrays ready for
upload.  A C++ builder (accel/native) provides a faster drop-in.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BUCKET_NUM = 20
MAX_PRIM = 1


@dataclass
class FlatBVH:
    """Flattened threaded BVH (possibly 6-way replicated).

    Arrays have leading axis `num_trees * num_nodes`; tree d occupies
    [d*num_nodes, (d+1)*num_nodes).
    """

    bbox_min: np.ndarray  # (D*N, 3) float32
    bbox_max: np.ndarray  # (D*N, 3) float32
    start: np.ndarray     # (D*N,) int32 — triangle range start
    end: np.ndarray       # (D*N,) int32
    hit: np.ndarray       # (D*N,) int32 — next node on hit (-1 = done)
    miss: np.ndarray      # (D*N,) int32 — next node on miss (-1 = done)
    num_nodes: int
    num_trees: int
    order: np.ndarray     # (T,) permutation applied to the input triangles


def _surface_area(pmin: np.ndarray, pmax: np.ndarray) -> float:
    if np.any(pmin > pmax):
        return 0.0
    d = pmax - pmin
    return float(2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]))


def build_bvh(
    tri_verts: np.ndarray,
    use_sah: bool = True,
    mtbvh: bool = True,
    use_native: bool = True,
    max_prim: int = MAX_PRIM,
    bucket_num: int = BUCKET_NUM,
) -> FlatBVH:
    """Build from (T, 3, 3) world-space triangle vertices.

    `use_native` tries the C++ builder (accel/native, ~100x the numpy
    builder on large meshes — the reference's build is C++ too,
    reference: src/BVH.cpp); falls back to numpy when no toolchain exists.
    `max_prim`/`bucket_num` mirror the reference's compile-time knobs
    (reference: src/BVH.h:5-6).
    """
    T = tri_verts.shape[0]
    if T == 0:
        z3 = np.zeros((0, 3), np.float32)
        zi = np.zeros((0,), np.int32)
        return FlatBVH(z3, z3, zi, zi, zi, zi, 0, 6 if mtbvh else 1, np.zeros(0, np.int64))

    bmin_tri = tri_verts.min(axis=1)  # (T,3)
    bmax_tri = tri_verts.max(axis=1)
    # triangle centroid = mean of vertices (reference: Bounds3.hpp Triangle::Centroid)
    centroids = tri_verts.mean(axis=1)

    if use_sah and use_native:
        try:
            from pathtracer.accel.native import build_sah_native

            res = build_sah_native(bmin_tri, bmax_tri, centroids, max_prim, bucket_num)
        except Exception:
            res = None
        if res is not None:
            order, bmin, bmax, start_a, end_a, left, right, parent = res
            n = bmin.shape[0]
            return _finish_links(
                bmin, bmax, start_a, end_a, left, right, parent, n, mtbvh, order
            )

    order = np.arange(T, dtype=np.int64)

    # node storage (preorder is assigned in a second pass)
    nodes_start: list[int] = []
    nodes_end: list[int] = []
    nodes_bmin: list[np.ndarray] = []
    nodes_bmax: list[np.ndarray] = []
    nodes_left: list[int] = []
    nodes_right: list[int] = []
    nodes_parent: list[int] = []

    # explicit preorder stack: (start, end, parent, is_right_child)
    stack: list[tuple[int, int, int]] = [(0, T, -1)]
    while stack:
        start, end, parent = stack.pop()
        idx = order[start:end]
        nb_min = bmin_tri[idx].min(axis=0)
        nb_max = bmax_tri[idx].max(axis=0)
        me = len(nodes_start)
        nodes_start.append(start)
        nodes_end.append(end)
        nodes_bmin.append(nb_min)
        nodes_bmax.append(nb_max)
        nodes_left.append(-1)
        nodes_right.append(-1)
        nodes_parent.append(parent)
        if parent >= 0:
            if nodes_left[parent] == -2:  # awaiting left
                nodes_left[parent] = me
            else:
                nodes_right[parent] = me

        if end - start <= max(max_prim, 1):
            continue

        cent = centroids[idx]
        cmin = cent.min(axis=0)
        cmax = cent.max(axis=0)
        diag = cmax - cmin
        # max-extent axis (reference: Bounds3::MaxExtent)
        if diag[0] > diag[1] and diag[0] > diag[2]:
            axis = 0
        elif diag[1] > diag[2]:
            axis = 1
        else:
            axis = 2

        mid = -1
        if use_sah and diag[axis] > 0:
            offs = np.clip((cent[:, axis] - cmin[axis]) / diag[axis], 0.0, 1.0)
            bidx = np.where(offs == 1.0, bucket_num - 1, (offs * bucket_num).astype(np.int64))
            bidx = np.minimum(bidx, bucket_num - 1)

            counts = np.bincount(bidx, minlength=bucket_num)
            # per-bucket bounds
            bk_min = np.full((bucket_num, 3), np.inf)
            bk_max = np.full((bucket_num, 3), -np.inf)
            np.minimum.at(bk_min, bidx, bmin_tri[idx])
            np.maximum.at(bk_max, bidx, bmax_tri[idx])

            best_loss = np.inf
            best_bucket = -1
            for i in range(bucket_num - 1):
                nl = counts[: i + 1].sum()
                nr = counts[i + 1 :].sum()
                if nl == 0 or nr == 0:
                    continue
                lmin = bk_min[: i + 1].min(axis=0)
                lmax = bk_max[: i + 1].max(axis=0)
                rmin = bk_min[i + 1 :].min(axis=0)
                rmax = bk_max[i + 1 :].max(axis=0)
                loss = nl * _surface_area(lmin, lmax) + nr * _surface_area(rmin, rmax)
                if loss < best_loss:
                    best_loss = loss
                    best_bucket = i
            if best_bucket >= 0:
                go_left = bidx <= best_bucket
                # stable partition, like std::partition's grouping
                left_idx = idx[go_left]
                right_idx = idx[~go_left]
                mid = start + len(left_idx)
                order[start:mid] = left_idx
                order[mid:end] = right_idx

        if mid <= start or mid >= end:
            # median split fallback (reference: recursiveBuildNaive,
            # src/BVH.cpp:94-118; also our degenerate-SAH guard)
            keys = centroids[idx][:, axis]
            perm = np.argsort(keys, kind="stable")
            order[start:end] = idx[perm]
            mid = (start + end) // 2

        nodes_left[me] = -2  # mark: next pushed preorder child is my left
        # push right first so left pops first (preorder)
        stack.append((mid, end, me))
        stack.append((start, mid, me))

    n = len(nodes_start)
    bmin = np.asarray(nodes_bmin, np.float32).reshape(n, 3)
    bmax = np.asarray(nodes_bmax, np.float32).reshape(n, 3)
    start_a = np.asarray(nodes_start, np.int32)
    end_a = np.asarray(nodes_end, np.int32)
    left = np.asarray(nodes_left, np.int32)
    right = np.asarray(nodes_right, np.int32)
    parent = np.asarray(nodes_parent, np.int32)
    return _finish_links(bmin, bmax, start_a, end_a, left, right, parent, n, mtbvh, order)


def _node_depths(parent: np.ndarray) -> np.ndarray:
    """Per-node depth from parent links (preorder ⇒ parent[i] < i), by
    repeated vectorized passes — one per tree level."""
    n = len(parent)
    depth = np.full(n, -1, np.int64)
    if n:
        depth[0] = 0
    while True:
        pending = depth < 0
        if not pending.any():
            return depth
        ready = pending & (depth[np.maximum(parent, 0)] >= 0)
        depth[ready] = depth[parent[ready]] + 1


def _finish_links(bmin, bmax, start_a, end_a, left, right, parent, n, mtbvh, order):
    """Threaded hit/miss linearization (+6-way MTBVH) from child/parent
    info (reference: src/BVH.cpp:198-236).  The miss/leaf-hit recurrence
    only reads the PARENT's links, so it resolves level-by-level with
    vectorized gathers instead of the per-node Python loop (which cost
    ~10 s at 1.28M nodes)."""
    if not mtbvh:
        hit, miss = _thread_links(left, right, parent)
        return FlatBVH(bmin, bmax, start_a, end_a, hit, miss, n, 1, order)

    internal = left != -1
    sib = np.full(n, -1, np.int32)
    li, ri = left[internal], right[internal]
    sib[li] = ri
    sib[ri] = li
    cent = (bmin + bmax) * 0.5

    # near child per direction (internal nodes; reference: src/BVH.cpp:198-222)
    near = np.zeros((6, n), np.int32)
    for d in range(6):
        axis = d % 3
        sign = 1.0 if d < 3 else -1.0
        key = cent[:, axis] * sign
        lk = key[np.maximum(left, 0)]
        rk = key[np.maximum(right, 0)]
        near[d] = np.where(internal & (lk > rk), right, left)

    depth = _node_depths(parent)
    misses = np.full((6, n), -1, np.int32)
    for lvl in range(1, int(depth.max()) + 1 if n else 0):
        idx = np.nonzero(depth == lvl)[0].astype(np.int32)
        pi = parent[idx]
        is_near = idx[None, :] == near[:, pi]
        misses[:, idx] = np.where(is_near, sib[idx][None, :], misses[:, pi])
    # internal hit = near child; leaf hit = its own miss link (the
    # sibling-or-parent-miss cases coincide; root leaf = -1)
    hits = np.where(internal[None, :], near, misses)

    tile = lambda a: np.tile(a, 6)
    return FlatBVH(
        np.tile(bmin, (6, 1)),
        np.tile(bmax, (6, 1)),
        tile(start_a),
        tile(end_a),
        hits.reshape(-1),
        misses.reshape(-1),
        n,
        6,
        order,
    )


def _thread_links(left: np.ndarray, right: np.ndarray, parent: np.ndarray):
    """Plain (non-MT) threading (reference: src/BVH.cpp:149-178),
    level-vectorized like the MTBVH variant."""
    n = len(left)
    hit = np.arange(1, n + 1, dtype=np.int32)
    if n:
        hit[-1] = -1
    miss = np.full(n, -1, np.int32)
    depth = _node_depths(parent)
    for lvl in range(1, int(depth.max()) + 1 if n else 0):
        idx = np.nonzero(depth == lvl)[0].astype(np.int32)
        pi = parent[idx]
        miss[idx] = np.where(idx == left[pi], right[pi], miss[pi])
    return hit, miss


def validate_bvh(bvh: FlatBVH, tri_verts_ordered: np.ndarray) -> list[str]:
    """Structural invariants used by tests (SURVEY.md §4)."""
    errors = []
    n = bvh.num_nodes
    for d in range(bvh.num_trees):
        o = d * n
        seen = np.zeros(0, np.int64)
        covered = []
        # walk every node; leaves partition [0, T)
        for i in range(n):
            s, e = int(bvh.start[o + i]), int(bvh.end[o + i])
            if e - s <= MAX_PRIM:
                covered.append((s, e))
            for link in (bvh.hit[o + i], bvh.miss[o + i]):
                if not (-1 <= link < n):
                    errors.append(f"tree {d} node {i}: link {link} out of range")
        covered.sort()
        pos = 0
        for s, e in covered:
            if s != pos:
                errors.append(f"tree {d}: leaf ranges not a partition at {s}")
                break
            pos = e
        if covered and pos != tri_verts_ordered.shape[0]:
            errors.append(f"tree {d}: leaves cover {pos} != T")
        # a full hit-walk from the root must visit every node exactly once
        # only for the non-MT layout (preorder next); for MT trees the walk
        # depends on AABB outcomes, so just check link ranges above.
        if bvh.num_trees == 1:
            visited = set()
            node = 0
            while node != -1 and len(visited) <= n:
                visited.add(node)
                node = int(bvh.hit[o + node])
            if len(visited) != n:
                errors.append(f"tree {d}: hit-chain visits {len(visited)} != {n}")
    return errors
