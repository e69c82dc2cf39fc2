"""Sample-space parallelism: every device renders the whole frame with a
different iteration stripe; accumulators combine by summation
(parallel/sharding.py sample_parallel_step)."""

import textwrap

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pathtracer.integrator.wavefront import CameraArrays, make_render_iteration
from pathtracer.parallel import sharding as sh
from pathtracer.scene.camera import derive_camera
from pathtracer.scene.flatscene import build_flat_scene
from pathtracer.scene.parser import load_scene
from pathtracer.utils import rng
from pathtracer.utils.config import RenderOptions, SampleMode


@pytest.mark.slow
def test_sample_parallel_equals_sequential(tmp_path, scenes_dir):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    scene = load_scene(scenes_dir / "cornell.txt")
    scene.camera.resolution = (48, 48)
    flat, static = build_flat_scene(scene)
    opts = RenderOptions(sample_mode=SampleMode.MIS)
    p, v, u, r, pl = derive_camera(scene.camera).as_arrays()
    cam = CameraArrays(*[jnp.asarray(x) for x in (p, v, u, r, pl)])
    key = rng.base_key(0)
    n = 48 * 48

    mesh = sh.make_mesh(8)
    step, combine = sh.sample_parallel_step(static, opts, 48, 48, mesh)
    img = jax.device_put(
        jnp.zeros((8 * n, 3), jnp.float32),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(sh.AXIS)),
    )
    rounds = 2
    for it in range(1, rounds + 1):
        img, rays = step(flat, cam, img, jnp.int32(it), key)
    combined = np.asarray(combine(img))
    assert int(rays) > 0

    # sequential reference: iterations 1..16 on one device
    full = jax.jit(make_render_iteration(static, opts, 48, 48))
    img1 = jnp.zeros((n, 3), jnp.float32)
    for it in range(1, 8 * rounds + 1):
        img1, _, _ = full(flat, cam, img1, jnp.int32(it), key)
    seq = np.asarray(img1)

    # same RNG streams per iteration index → statistically identical sums;
    # compare means tightly and pixels loosely (XLA shape-codegen chaos)
    assert abs(combined.mean() - seq.mean()) / max(seq.mean(), 1e-9) < 0.05
    a = np.clip(combined / (8 * rounds), 0, 1) ** (1 / 2.2)
    b = np.clip(seq / (8 * rounds), 0, 1) ** (1 / 2.2)
    rmse = float(np.sqrt(((a - b) ** 2).mean()))
    assert rmse < 0.12, rmse
