"""BVH build invariants + traversal-equivalence ground truth
(reference semantics: src/BVH.cpp:149-239)."""

import numpy as np
import pytest

from pathtracer.accel.bvh import MAX_PRIM, FlatBVH, build_bvh, validate_bvh


def random_tris(n, seed=0, spread=10.0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, size=(n, 1, 3))
    offs = rng.uniform(-0.5, 0.5, size=(n, 3, 3))
    return (centers + offs).astype(np.float32)


class TestBuild:
    def test_empty(self):
        bvh = build_bvh(np.zeros((0, 3, 3), np.float32))
        assert bvh.num_nodes == 0

    def test_single_triangle(self):
        bvh = build_bvh(random_tris(1), mtbvh=False)
        assert bvh.num_nodes == 1
        assert bvh.hit[0] == -1 and bvh.miss[0] == -1
        assert bvh.start[0] == 0 and bvh.end[0] == 1

    @pytest.mark.parametrize("n", [2, 7, 64, 500])
    def test_invariants(self, n):
        tris = random_tris(n, seed=n)
        bvh = build_bvh(tris, mtbvh=False)
        # with MAX_PRIM=1, a binary tree over n leaves has 2n-1 nodes
        assert bvh.num_nodes == 2 * n - 1
        tris_ordered = tris[bvh.order]
        assert validate_bvh(bvh, tris_ordered) == []
        # preorder hit threading: hit[i] == i+1 (reference: src/BVH.cpp:158-160)
        np.testing.assert_array_equal(bvh.hit[:-1], np.arange(1, bvh.num_nodes))
        assert bvh.hit[-1] == -1

    def test_node_bounds_contain_triangles(self):
        tris = random_tris(100, seed=5)
        bvh = build_bvh(tris, mtbvh=False)
        t = tris[bvh.order]
        for i in range(bvh.num_nodes):
            s, e = bvh.start[i], bvh.end[i]
            sub = t[s:e].reshape(-1, 3)
            assert (sub.min(0) >= bvh.bbox_min[i] - 1e-4).all()
            assert (sub.max(0) <= bvh.bbox_max[i] + 1e-4).all()

    def test_degenerate_identical_centroids(self):
        # all triangles at the same spot — the reference would loop forever;
        # we fall back to median split (documented divergence)
        tris = np.tile(random_tris(1), (16, 1, 1))
        bvh = build_bvh(tris, mtbvh=False)
        assert bvh.num_nodes == 31
        assert validate_bvh(bvh, tris[bvh.order]) == []


class TestMTBVH:
    def test_six_replicas(self):
        tris = random_tris(50, seed=9)
        bvh = build_bvh(tris, mtbvh=True)
        assert bvh.num_trees == 6
        n = bvh.num_nodes
        assert bvh.bbox_min.shape[0] == 6 * n
        # geometric data identical across replicas
        for d in range(1, 6):
            np.testing.assert_array_equal(bvh.bbox_min[:n], bvh.bbox_min[d * n : (d + 1) * n])
            np.testing.assert_array_equal(bvh.start[:n], bvh.start[d * n : (d + 1) * n])
        assert validate_bvh(bvh, tris[bvh.order]) == []

    def test_near_child_first(self):
        # internal node's hit link points at the child nearer along the axis
        tris = random_tris(64, seed=11)
        bvh = build_bvh(tris, mtbvh=True)
        n = bvh.num_nodes
        cent = (bvh.bbox_min[:n] + bvh.bbox_max[:n]) / 2
        for d in range(6):
            axis, sign = d % 3, (1 if d < 3 else -1)
            o = d * n
            for i in range(n):
                if bvh.end[o + i] - bvh.start[o + i] <= MAX_PRIM:
                    continue  # leaf
                hit = bvh.hit[o + i]
                assert hit != -1
                # hit child must be a child range subset and the nearer one
                assert bvh.start[o + hit] >= bvh.start[o + i]
                assert bvh.end[o + hit] <= bvh.end[o + i]

    def test_traversal_walk_covers_all_leaves(self):
        # walking the MT tree taking EVERY hit link (as if every AABB test
        # passed) must visit all leaves exactly once per tree
        tris = random_tris(33, seed=13)
        bvh = build_bvh(tris, mtbvh=True)
        n = bvh.num_nodes
        for d in range(6):
            o = d * n
            node, seen, steps = 0, [], 0
            while node != -1 and steps < 4 * n:
                if bvh.end[o + node] - bvh.start[o + node] <= MAX_PRIM:
                    seen.append(int(bvh.start[o + node]))
                node = int(bvh.hit[o + node])
                steps += 1
            assert sorted(seen) == list(range(33)), f"dir {d}"

    def test_miss_walk_terminates(self):
        tris = random_tris(20, seed=17)
        bvh = build_bvh(tris, mtbvh=True)
        n = bvh.num_nodes
        for d in range(6):
            o = d * n
            node, steps = 0, 0
            while node != -1 and steps < 4 * n:
                node = int(bvh.miss[o + node])
                steps += 1
            assert node == -1
