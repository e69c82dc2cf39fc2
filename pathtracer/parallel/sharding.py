"""Multi-chip scaling via jax.sharding.Mesh + shard_map.

The reference is strictly single-GPU (SURVEY.md §2 'Parallelism &
communication': zero collectives, only H2D/D2H memcpys).  Path tracing is
embarrassingly parallel across pixels, so the scale-out design is:

- PIXEL-SPACE sharding (default): the ray pool and accumulation image are
  sharded by pixel rows across the mesh axis; the scene is replicated.
  Each device renders its own rows; no inter-chip traffic in the hot loop.
  Per-iteration ray counters are `psum`'d across devices for global throughput
  stats, and `fetch_image` gathers the shards only when saving.

- SAMPLE-SPACE sharding (`sample_parallel_render`): every device renders
  the FULL image with a different iteration offset (counter-based RNG makes
  the streams independent by construction), and the accumulators are
  summed with `psum` — one all-reduce per fetch.  This is the
  right axis when the image is small but spp is large.

Because the RNG is keyed on global pixel index (utils/rng.pixel_uniforms),
a sharded render draws the same samples as the single-device render
WITHOUT the pixel swizzle (`RenderOptions.swizzle=False`; the swizzled pool
keys the RNG by lane, so it matches only in distribution).  The two agree
to float rounding: XLA may fuse the per-shard and the full-frame program
differently (tests/test_sharding.py, `chip_smoke.py --four`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pathtracer.integrator.wavefront import CameraArrays, make_render_iteration
from pathtracer.scene.flatscene import FlatScene, SceneStatic
from pathtracer.utils.config import RenderOptions

AXIS = "px"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    import numpy as np

    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} devices are visible (for CPU testing set "
                f"XLA_FLAGS=--xla_force_host_platform_device_count={n_devices})"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices).reshape(-1), (AXIS,))


def padded_height(height: int, n_dev: int) -> int:
    """Image rows are padded so the pool splits evenly across the mesh."""
    return ((height + n_dev - 1) // n_dev) * n_dev


def make_sharded_iteration(
    static: SceneStatic,
    opts: RenderOptions,
    width: int,
    height: int,
    mesh: Mesh,
):
    """Pixel-space sharded render step.

    Returns (step, img_sharding, padded_height): step(flat, cam, img,
    iteration, key) → (img, rays_traced, depth) where img is (padded_H·W, 3)
    sharded by rows, rays_traced is the global (psum'd) count and depth is
    the deepest bounce lap any shard executed (pmax — the live
    TracedDepth stat, reference: src/pathtrace.cu:793-796).
    """
    n_dev = mesh.shape[AXIS]
    ph = padded_height(height, n_dev)
    local_h = ph // n_dev
    local_iter = make_render_iteration(static, opts, width, height, local_rows=local_h)

    def local_step(flat, cam, img_local, iteration, key):
        d = jax.lax.axis_index(AXIS)
        pixel0 = d.astype(jnp.int32) * jnp.int32(local_h * width)
        img_local, rays, depth = local_iter(flat, cam, img_local, iteration, key, pixel0)
        rays = jax.lax.psum(rays, AXIS)
        depth = jax.lax.pmax(depth, AXIS)
        return img_local, rays, depth

    step = jax.jit(
        jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P(), P(), P(AXIS), P(), P()),
            out_specs=(P(AXIS), P(), P()),
            check_vma=False,
        )
    )
    img_sharding = NamedSharding(mesh, P(AXIS))
    return step, img_sharding, ph


def zeros_image(width: int, height: int, mesh: Mesh):
    """Device-sharded zero accumulator of padded size."""
    n_dev = mesh.shape[AXIS]
    ph = padded_height(height, n_dev)
    sharding = NamedSharding(mesh, P(AXIS))
    return jax.device_put(jnp.zeros((ph * width, 3), jnp.float32), sharding)


def fetch_image(img, width: int, height: int):
    """Gather shards to host and drop row padding."""
    import numpy as np

    return np.asarray(img).reshape(-1, width, 3)[:height]


def sample_parallel_step(
    static: SceneStatic,
    opts: RenderOptions,
    width: int,
    height: int,
    mesh: Mesh,
):
    """Sample-space parallelism: each device renders the whole frame with a
    different iteration stripe; accumulators combine with one psum."""
    n_dev = mesh.shape[AXIS]
    full_iter = make_render_iteration(static, opts, width, height)

    def local_step(flat, cam, img_local, iteration, key):
        d = jax.lax.axis_index(AXIS)
        # device d renders iteration n_dev*(iteration-1) + d + 1
        it = (iteration - 1) * n_dev + d.astype(jnp.int32) + 1
        img_local, rays, _ = full_iter(flat, cam, img_local, it, key)
        rays = jax.lax.psum(rays, AXIS)
        return img_local, rays

    step = jax.jit(
        jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P(), P(), P(AXIS), P(), P()),
            out_specs=(P(AXIS), P()),
            check_vma=False,
        )
    )

    def combine(img_stack):
        # (n_dev · H·W, 3) stacked accumulators → summed (H·W, 3)
        return jnp.sum(img_stack.reshape(n_dev, -1, 3), axis=0)

    return step, combine
