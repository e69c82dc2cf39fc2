"""material_by_geom (static select-chain over compile-time immediates)
must agree exactly with gather_material (dynamic table gather) for every
valid geom index — locks the SceneStatic.mat_rows_f/i immediates against
the flat.mat_f32/mat_i32 tables they mirror.

reference: src/sceneStructs.h Material + src/pathtrace.cu:447 (materials
are read per-hit by material id; ours resolves them per-geom at compile
time, which is only sound if the two paths agree)."""

from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

from pathtracer.ops.materials import gather_material, material_by_geom
from pathtracer.scene.flatscene import build_flat_scene
from pathtracer.scene.parser import load_scene

_SCENES = Path(__file__).resolve().parent.parent / "scenes"
SCENES = [
    str(_SCENES / "dielectric_test.txt"),   # 5 materials, untextured
    str(_SCENES / "cornell.txt"),           # shared-material groups
    str(_SCENES / "texturecube.txt"),       # textured albedo chain
]


@pytest.mark.parametrize("path", SCENES)
def test_chain_matches_gather(path):
    scene = load_scene(path)
    flat, static = build_flat_scene(scene)
    rng = np.random.default_rng(7)
    n = 257
    geom = jnp.asarray(
        rng.integers(0, len(static.geom_mats), size=n), jnp.int32
    )
    uv = jnp.asarray(rng.random((n, 2), np.float32))
    mat_id = jnp.asarray(np.asarray(static.geom_mats), jnp.int32)[geom]

    got = material_by_geom(flat, static, geom, uv)
    want = gather_material(flat, static, mat_id, uv)
    for field in got._fields:
        g, w = np.asarray(getattr(got, field)), np.asarray(getattr(want, field))
        if g.dtype.kind == "f":
            # the two graphs fuse the bilinear blend differently → 1-ULP
            # drift on textured components; constants must match exactly
            assert np.allclose(g, w, rtol=0, atol=2e-7), (
                f"{path}: {field} chain != gather "
                f"(max {np.abs(g - w).max()})"
            )
        else:
            assert np.array_equal(g, w), f"{path}: {field} chain != gather"
