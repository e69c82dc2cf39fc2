"""The per-ray traversal kernel (ops/traverse_kernel.py, interpret mode on
the CPU) must agree with the XLA walk, and the platform picks the walk."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.ops import traverse_kernel as tk
from pathtracer.ops.traverse import (
    FLT_MAX,
    _bvh_occluded,
    closest_hit,
    occlusion_test,
    resolve_traversal,
)
from pathtracer.ops.traverse_kernel import DEAD_T
from pathtracer.scene.flatscene import build_flat_scene
from pathtracer.scene.parser import load_scene
from pathtracer.utils.config import RenderOptions
from tests.test_traverse import random_rays, tri_soup_scene

SCENES = Path(__file__).resolve().parent.parent / "scenes"


@pytest.fixture(scope="module")
def soup_scene(tmp_path_factory):
    return load_scene(tri_soup_scene(tmp_path_factory.mktemp("soup_k"), n=200, seed=3))


def _build(scene, mtbvh=True, max_prim=1):
    return build_flat_scene(
        scene, opts=RenderOptions(use_mtbvh=mtbvh, max_prim=max_prim)
    )


def _kargs(static, block=tk.BLOCK):
    return dict(num_nodes=static.num_bvh_nodes, num_trees=static.num_bvh_trees,
                max_prim=static.max_prim, block=block, interpret=True)


def _closest(flat, static, o, d, t_init, block=tk.BLOCK):
    return tk.closest_hit_kernel(
        flat.bvh_f32, flat.bvh_i32, flat.tri_data, o, d, t_init,
        **_kargs(static, block),
    )


class TestClosest:
    # the 6-tree MTBVH exercises the per-ray octant selection; the single
    # threaded tree and 4-triangle leaves the other layouts the walk reads
    @pytest.mark.parametrize("mtbvh,max_prim", [(True, 1), (False, 1), (True, 4), (False, 4)])
    def test_matches_xla_walk(self, soup_scene, mtbvh, max_prim):
        flat, static = _build(soup_scene, mtbvh, max_prim)
        assert static.num_bvh_trees == (6 if mtbvh else 1)
        o, d = random_rays(1024, seed=21)
        ref = closest_hit(flat, static, o, d)
        t, tri, u, v = _closest(flat, static, o, d, jnp.full((1024,), FLT_MAX))
        ref_tri = np.asarray(ref.tri)
        np.testing.assert_array_equal(np.asarray(tri), ref_tri)
        hits = ref_tri >= 0
        assert hits.sum() > 20
        np.testing.assert_allclose(np.asarray(t)[hits], np.asarray(ref.t)[hits], rtol=1e-5)

    def test_respects_t_init(self, soup_scene):
        flat, static = _build(soup_scene)
        o, d = random_rays(512, seed=22)
        # with a tiny t budget nothing can beat it
        t, tri, _, _ = _closest(flat, static, o, d, jnp.full((512,), 1e-3))
        assert (np.asarray(tri) == -1).all()
        np.testing.assert_array_equal(np.asarray(t), np.float32(1e-3))

    def test_dead_sentinel_is_inert(self, soup_scene):
        flat, static = _build(soup_scene)
        o, d = random_rays(512, seed=26)
        _, tri, _, _ = _closest(flat, static, o, d, jnp.full((512,), DEAD_T))
        assert (np.asarray(tri) == -1).all()

    @pytest.mark.parametrize("block", [32, 128])
    def test_pool_padding(self, soup_scene, block):
        flat, static = _build(soup_scene)
        o, d = random_rays(1000, seed=23)  # not a multiple of the block
        t, tri, _, _ = _closest(flat, static, o, d, jnp.full((1000,), FLT_MAX), block)
        assert t.shape == tri.shape == (1000,)
        ref = closest_hit(flat, static, o, d)
        np.testing.assert_array_equal(np.asarray(tri), np.asarray(ref.tri))

    def test_full_hit_record_matches(self, soup_scene, kernel_walk):
        """closest_hit through the kernel: the same geom, point, normal and
        uv as through the XLA walk, with dead lanes skipped."""
        flat, static = _build(soup_scene)
        o, d = random_rays(512, seed=24)
        alive = jnp.arange(512) % 5 != 0
        ref = closest_hit(flat, static, o, d)
        got = closest_hit(flat, static, o, d, alive=alive, traversal="kernel")
        live = np.asarray(alive)
        assert (np.asarray(got.tri)[~live] == -1).all()
        for field in ("geom", "tri", "point", "normal", "uv"):
            np.testing.assert_allclose(
                np.asarray(getattr(got, field))[live],
                np.asarray(getattr(ref, field))[live], rtol=1e-5, atol=1e-6,
            )


class TestOcclusion:
    @pytest.mark.parametrize("mtbvh,max_prim", [(True, 1), (False, 4)])
    def test_matches_xla_walk(self, soup_scene, mtbvh, max_prim):
        flat, static = _build(soup_scene, mtbvh, max_prim)
        o, d = random_rays(1024, seed=25)
        min_t = jnp.full((1024,), 3.0, jnp.float32)
        ref = _bvh_occluded(flat, static, o, d, min_t, jnp.ones((1024,), bool))
        got = tk.occlusion_kernel(flat.bvh_f32, flat.bvh_i32, flat.tri_data,
                                  o, d, min_t, **_kargs(static))
        assert np.asarray(ref).sum() > 20
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))

    def test_disabled_sentinel_never_blocks(self, soup_scene):
        flat, static = _build(soup_scene)
        o, d = random_rays(512, seed=27)
        got = tk.occlusion_kernel(flat.bvh_f32, flat.bvh_i32, flat.tri_data,
                                  o, d, jnp.full((512,), DEAD_T), **_kargs(static))
        assert not np.asarray(got).any()

    def test_pre_occluded_and_disabled_lanes(self, kernel_walk):
        """occlusion_test on a scene with walls and a mesh: lanes an
        analytic geom already blocks stay blocked, disabled lanes are never
        traced, and the kernel path equals the XLA path lane for lane."""
        scene = load_scene(SCENES / "glassbunny.txt")
        flat, static = build_flat_scene(scene)
        key = jax.random.PRNGKey(5)
        k1, k2 = jax.random.split(key)
        lo = jnp.array([-4.5, 0.5, -4.5])
        hi = jnp.array([4.5, 9.5, 4.5])
        ori = lo + (hi - lo) * jax.random.uniform(k1, (512, 3))
        des = lo + (hi - lo) * jax.random.uniform(k2, (512, 3)) * 1.2
        dirn = (des - ori) / jnp.linalg.norm(des - ori, axis=1, keepdims=True)
        enabled = jnp.arange(512) % 3 != 0
        ref = occlusion_test(flat, static, ori, dirn, des, enabled=enabled)
        got = occlusion_test(flat, static, ori, dirn, des, enabled=enabled,
                             traversal="kernel")
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
        analytic = occlusion_test(flat, static, ori, dirn, des,
                                  enabled=jnp.zeros((512,), bool))
        assert np.asarray(analytic).any()  # the walls block some segments
        assert np.asarray(got)[np.asarray(analytic)].all()
        assert np.asarray(got)[~np.asarray(enabled)].sum() == np.asarray(analytic)[~np.asarray(enabled)].sum()
        assert (np.asarray(got) & ~np.asarray(analytic)).any()  # the mesh blocks some


class TestPlatformChoice:
    @pytest.mark.parametrize(
        "choice,platform,want",
        [("auto", "cpu", "xla"), ("auto", "gpu", "kernel"), ("xla", "gpu", "xla"),
         ("xla", "cpu", "xla")],
    )
    def test_resolve(self, choice, platform, want):
        assert resolve_traversal(choice, platform) == want

    @pytest.mark.parametrize(
        "choice,platform",
        [("kernel", "cpu"), ("interpret", "cpu"), ("interpret", "gpu"), ("packets", "gpu")],
    )
    def test_refused(self, choice, platform):
        with pytest.raises(ValueError):
            resolve_traversal(choice, platform)

    def test_wrapper_refuses_interpret_on_gpu(self, soup_scene, monkeypatch):
        flat, static = _build(soup_scene)
        o, d = random_rays(128, seed=1)
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        with pytest.raises(ValueError, match="interpret"):
            _closest(flat, static, o, d, jnp.full((128,), FLT_MAX))
