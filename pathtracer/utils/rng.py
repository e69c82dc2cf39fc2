"""Counter-based RNG for the wavefront integrator.

The reference hash-seeds a thrust engine per (iter, index, depth)
(reference: src/pathtrace.cu:25-29 makeSeededRandomEngine,
src/intersections.h:12-20 utilhash).  Here we use JAX's counter-based
threefry keyed on (iteration, bounce, stage): bitwise-reproducible across
runs and shardings, with no per-thread engine state.  Parity with the
reference is statistical (RMSE at equal spp), not bitwise — see SURVEY.md §7.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Stage ids — one independent stream per consumer per bounce.
STAGE_CAMERA = 0
STAGE_SCATTER = 1
STAGE_LIGHT = 2


def base_key(seed: int = 0) -> jax.Array:
    return jax.random.PRNGKey(seed)


def stream(key: jax.Array, iteration, depth, stage: int) -> jax.Array:
    """Derive the (iteration, bounce, stage) stream key."""
    k = jax.random.fold_in(key, iteration)
    k = jax.random.fold_in(k, depth)
    return jax.random.fold_in(k, stage)


def uniforms(key: jax.Array, iteration, depth, stage: int, shape) -> jax.Array:
    """U[0,1) block for one wavefront stage (lane-indexed; single-shard only)."""
    return jax.random.uniform(stream(key, iteration, depth, stage), shape, jnp.float32)


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds), hand-vectorized over counter arrays.

    Same algorithm family as JAX's PRNG but implemented with public jnp ops
    so it vectorizes as plain elementwise code (the jax.vmap(fold_in)
    formulation materialized per-lane key pairs).
    """
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    k2 = k0 ^ k1 ^ jnp.uint32(0x1BD11BDA)
    ks = (k0, k1, k2)

    def rotl(v, r):
        return (v << jnp.uint32(r)) | (v >> jnp.uint32(32 - r))

    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for d in range(5):
        for r in rotations[d % 2]:
            x0 = x0 + x1
            x1 = rotl(x1, r)
            x1 = x0 ^ x1
        x0 = x0 + ks[(d + 1) % 3]
        x1 = x1 + ks[(d + 2) % 3] + jnp.uint32(d + 1)
    return x0, x1


def pixel_uniforms(
    key: jax.Array, iteration, depth, stage: int, pixel_idx: jax.Array, ncols: int
) -> jax.Array:
    """U[0,1) block keyed by GLOBAL pixel index, (N, ncols).

    Position-based rather than lane-based: pixel p draws the same values
    whether the pool is whole or sharded across a device mesh, so
    single-device and multi-device renders agree (the counterpart of the
    reference's per-pixel hash seeding,
    reference: src/pathtrace.cu:25-29,148).

    `iteration` and `depth` may be scalars OR per-lane arrays (shape of
    `pixel_idx`): the persistent-wavefront regeneration path runs lanes
    at different sample indices and bounce depths within one dispatch.
    The stream identity is the packed counter word — threefry is a PRF
    over (key, counter), so distinct (iteration, depth, stage, block)
    packings give independent streams, and a lane draws bit-identical
    values whether its (iteration, depth) arrived as a scalar or as an
    array element.  Bit budget: block 0-1, stage 2-3, depth 4-11
    (trace depth <= 255), iteration 12-31 (<= ~1M samples/pixel —
    beyond that the word wraps and streams recycle).
    """
    kd = jax.random.key_data(key).astype(jnp.uint32).reshape(-1)
    k0 = jnp.broadcast_to(kd[0], pixel_idx.shape)
    k1 = jnp.broadcast_to(kd[-1], pixel_idx.shape)
    base = (
        (jnp.asarray(iteration).astype(jnp.uint32) << jnp.uint32(12))
        | (jnp.asarray(depth).astype(jnp.uint32) << jnp.uint32(4))
        | jnp.uint32(int(stage) << 2)
    )
    base = jnp.broadcast_to(base, pixel_idx.shape)
    cols = []
    pix = pixel_idx.astype(jnp.uint32)

    def u01(x):
        # uint32 → U[0,1): take 23 mantissa bits (standard construction)
        return (x >> jnp.uint32(9)).astype(jnp.float32) * jnp.float32(1.0 / (1 << 23))

    # each threefry block yields TWO independent 32-bit halves — use both
    # (the 20-round block cipher is ~3 ms/iter on a 640k pool at 3 calls;
    # pairing halves the call count for the same keying/determinism)
    c = 0
    while len(cols) < ncols:
        x0, x1 = _threefry2x32(k0, k1, pix, base | jnp.uint32(c))
        cols.append(u01(x0))
        if len(cols) < ncols:
            cols.append(u01(x1))
        c += 1
    return jnp.stack(cols, axis=-1)
