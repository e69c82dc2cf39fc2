"""Per-ray stackless MTBVH traversal: the GPU kernel.

One ray per thread, as in the reference's `computeIntersections`
(reference: src/pathtrace.cu:236-279) and its shadow walk
(src/lightSample.h:59-139).  Each ray picks its tree of the 6-way MTBVH by
its dominant direction axis and sign (src/pathtrace.cu:241-246) and follows
the threaded hit/miss links of that tree until it falls off the end (link
-1), testing its leaves' triangles on the way.  The tables are the ones
`scene/flatscene.build_flat_scene` makes for the XLA walk
(`ops/traverse._bvh_closest`): `bvh_f32` (D·N, 8) node bounds, `bvh_i32`
(D·N, 4) [start end hit miss] and the vertex columns of `tri_data`.

Written in Pallas for the Triton route.  Rays are grouped in blocks of
`block` lanes (one per thread); a block loops until its own lanes are
done, so unlike the XLA walk, whose every step gathers for the whole pool
and runs as long as the pool's slowest ray, a block stops at its own
slowest.  Loads are masked to the lanes that need them.  Lanes padded
onto the end of the pool carry the dead-lane sentinel `DEAD_T` and fail
the root's box test.

`interpret=True` runs the kernel body on the CPU.  It exists for tests;
on a GPU it raises.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

FLT_MAX = 3.402823466e38
DEAD_T = -FLT_MAX  # t budget of dead lanes: below every finite box entry
BLOCK = 128  # rays per program (one per thread)


def _octant_offset(dx, dy, dz, num_nodes: int, num_trees: int):
    """First node of the ray's MTBVH tree (reference: src/pathtrace.cu:241-246),
    the same choice as ops/traverse._mtbvh_offset."""
    if num_trees != 6:
        return jnp.zeros(dx.shape, jnp.int32)
    ax, ay, az = jnp.abs(dx), jnp.abs(dy), jnp.abs(dz)
    x_major = (ax > ay) & (ax > az)
    y_major = ~x_major & (ay > az)
    comp = jnp.where(x_major, dx, jnp.where(y_major, dy, dz))
    axis = jnp.where(x_major, 0, jnp.where(y_major, 1, 2))
    octant = axis + jnp.where(comp > 0.0, 0, 3)
    return octant * num_nodes


def _box(lo, hi, o, d):
    """One axis of the slab test (ops/intersect.ray_aabb): parallel rays
    keep or reject the axis by origin containment."""
    inv = 1.0 / d
    a = (lo - o) * inv
    b = (hi - o) * inv
    zero = d == 0.0
    inside = (o >= lo) & (o <= hi)
    t0 = jnp.where(zero, jnp.where(inside, -jnp.inf, jnp.inf), jnp.minimum(a, b))
    t1 = jnp.where(zero, jnp.where(inside, jnp.inf, -jnp.inf), jnp.maximum(a, b))
    return t0, t1


def _triangle(v0, v1, v2, o, d):
    """Möller–Trumbore on columns (ops/intersect.ray_triangle)."""
    e1 = [v1[i] - v0[i] for i in range(3)]
    e2 = [v2[i] - v0[i] for i in range(3)]
    p = [d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
         d[0] * e2[1] - d[1] * e2[0]]
    det = e1[0] * p[0] + e1[1] * p[1] + e1[2] * p[2]
    inv_det = 1.0 / jnp.where(det == 0.0, 1.0, det)
    tv = [o[i] - v0[i] for i in range(3)]
    u = (tv[0] * p[0] + tv[1] * p[1] + tv[2] * p[2]) * inv_det
    q = [tv[1] * e1[2] - tv[2] * e1[1], tv[2] * e1[0] - tv[0] * e1[2],
         tv[0] * e1[1] - tv[1] * e1[0]]
    v = (d[0] * q[0] + d[1] * q[1] + d[2] * q[2]) * inv_det
    t = (e2[0] * q[0] + e2[1] * q[1] + e2[2] * q[2]) * inv_det
    hit = (det != 0.0) & (t >= 0.0) & (u >= 0.0) & (v >= 0.0) & (1.0 - u - v >= 0.0)
    return hit, t, u, v


def _walk_kernel(bvh_f_ref, bvh_i_ref, tri_ref, ox_ref, oy_ref, oz_ref,
                 dx_ref, dy_ref, dz_ref, t_ref, *out_refs,
                 num_nodes: int, num_trees: int, max_prim: int, any_hit: bool):
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    t0 = t_ref[...]
    offset = _octant_offset(*d, num_nodes, num_trees)
    num_tris = tri_ref.shape[0]
    max_steps = 4 * num_nodes + 4
    zero_f = jnp.zeros_like(t0)
    zero_i = jnp.zeros(t0.shape, jnp.int32)

    def gather(ref, row, col, mask):
        return plgpu.load(ref.at[row, col], mask=mask, other=0)

    def cond(state):
        step, node = state[0], state[1]
        return (jnp.max(node) >= 0) & (step < max_steps)

    def body(state):
        step, node, t, tri, u, v = state
        active = node >= 0
        nidx = offset + jnp.clip(node, 0, num_nodes - 1)
        t_enter, t_exit = None, None
        for ax in range(3):
            lo = gather(bvh_f_ref, nidx, ax, active)
            hi = gather(bvh_f_ref, nidx, 3 + ax, active)
            a, b = _box(lo, hi, o[ax], d[ax])
            t_enter = a if t_enter is None else jnp.maximum(t_enter, a)
            t_exit = b if t_exit is None else jnp.minimum(t_exit, b)
        limit = t0 if any_hit else t
        box_ok = active & (t_enter <= t_exit) & (t_exit > 0.0) & (t_enter <= limit)
        start = gather(bvh_i_ref, nidx, 0, active)
        end = gather(bvh_i_ref, nidx, 1, active)
        leaf = box_ok & (end - start <= max_prim)
        blocked = jnp.zeros(t0.shape, jnp.bool_)
        for k in range(max_prim):  # static unroll over the leaf span
            tidx = jnp.clip(start + k, 0, num_tris - 1)
            want = leaf & (start + k < end)
            v0 = [gather(tri_ref, tidx, c, want) for c in range(0, 3)]
            v1 = [gather(tri_ref, tidx, c, want) for c in range(3, 6)]
            v2 = [gather(tri_ref, tidx, c, want) for c in range(6, 9)]
            th, tt, tu, tv = _triangle(v0, v1, v2, o, d)
            if any_hit:
                # shadow window (reference: src/lightSample.h:108-118)
                blocked = blocked | (want & th & (t0 - 1e-5 > tt)
                                     & (jnp.abs(tt - t0) > 1e-4))
            else:
                take = want & th & (tt < t)
                t = jnp.where(take, tt, t)
                tri = jnp.where(take, tidx, tri)
                u = jnp.where(take, tu, u)
                v = jnp.where(take, tv, v)
        hit_link = gather(bvh_i_ref, nidx, 2, box_ok)
        miss_link = gather(bvh_i_ref, nidx, 3, active & ~box_ok)
        nxt = jnp.where(box_ok, hit_link, miss_link)
        if any_hit:
            tri = jnp.where(blocked, 1, tri)  # tri doubles as the flag
            active = active & ~blocked  # early out on the first blocker
        node = jnp.where(active, nxt, -1)
        return step + 1, node, t, tri, u, v

    init = (jnp.int32(0), zero_i, t0, zero_i - 1, zero_f, zero_f)
    if any_hit:
        init = init[:3] + (zero_i,) + init[4:]
    _, _, t, tri, u, v = jax.lax.while_loop(cond, body, init)
    if any_hit:
        out_refs[0][...] = tri
    else:
        for ref, val in zip(out_refs, (t, tri, u, v)):
            ref[...] = val


def _check_interpret(interpret: bool) -> None:
    if interpret and jax.default_backend() != "cpu":
        raise ValueError(
            "interpret=True runs the traversal kernel on the CPU for tests; "
            f"on the {jax.default_backend()} backend the kernel compiles"
        )


@functools.partial(
    jax.jit,
    static_argnames=("num_nodes", "num_trees", "max_prim", "any_hit",
                     "block", "interpret"),
)
def _walk(bvh_f32, bvh_i32, tri_data, o, d, t, *, num_nodes, num_trees,
          max_prim, any_hit, block, interpret):
    n = o.shape[0]
    padded = -(-n // block) * block
    pad = padded - n
    cols = [o[:, i] for i in range(3)] + [d[:, i] for i in range(3)]
    cols = [jnp.pad(c, (0, pad), constant_values=v)
            for c, v in zip(cols, (0.0, 0.0, 0.0, 1.0, 1.0, 1.0))]
    t = jnp.pad(t.astype(jnp.float32), (0, pad), constant_values=DEAD_T)
    lane = pl.BlockSpec((block,), lambda i: (i,))
    table = pl.no_block_spec  # whole table; rows are gathered per lane
    kernel = functools.partial(
        _walk_kernel, num_nodes=num_nodes, num_trees=num_trees,
        max_prim=max_prim, any_hit=any_hit,
    )
    if any_hit:
        out_shape = [jax.ShapeDtypeStruct((padded,), jnp.int32)]
    else:
        out_shape = [jax.ShapeDtypeStruct((padded,), dt) for dt in
                     (jnp.float32, jnp.int32, jnp.float32, jnp.float32)]
    outs = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(padded // block,),
        in_specs=[table, table, table] + [lane] * 7,
        out_specs=[lane] * len(out_shape),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(block // 32, 1), num_stages=1
        ),
        interpret=interpret,
        name="bvh_occlusion" if any_hit else "bvh_closest",
    )(bvh_f32, bvh_i32, tri_data, *cols, t)
    return [x[:n] for x in outs]


def closest_hit_kernel(bvh_f32, bvh_i32, tri_data, o, d, t_init, *,
                       num_nodes: int, num_trees: int, max_prim: int = 1,
                       block: int = BLOCK, interpret: bool = False):
    """Closest triangle hit per ray with t < t_init.  Returns (t, tri, u,
    v); tri = -1 (and t = t_init) where no triangle is nearer.  Lanes with
    t_init = DEAD_T are skipped."""
    _check_interpret(interpret)
    t, tri, u, v = _walk(
        bvh_f32, bvh_i32, tri_data, o, d, t_init, num_nodes=num_nodes,
        num_trees=num_trees, max_prim=max(max_prim, 1), any_hit=False,
        block=block, interpret=interpret,
    )
    return t, tri, u, v


def occlusion_kernel(bvh_f32, bvh_i32, tri_data, o, d, min_t, *,
                     num_nodes: int, num_trees: int, max_prim: int = 1,
                     block: int = BLOCK, interpret: bool = False):
    """Is a triangle strictly inside the shadow window before min_t?
    (N,) bool; lanes with min_t = DEAD_T never block."""
    _check_interpret(interpret)
    (flag,) = _walk(
        bvh_f32, bvh_i32, tri_data, o, d, min_t, num_nodes=num_nodes,
        num_trees=num_trees, max_prim=max(max_prim, 1), any_hit=True,
        block=block, interpret=interpret,
    )
    return flag != 0
