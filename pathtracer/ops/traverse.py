"""Batched scene traversal: closest-hit and occlusion (any-hit) queries.

Rebuild of the reference's intersection kernels: the brute-force loop
over analytic geoms plus the stackless threaded-MTBVH walk
(reference: src/pathtrace.cu:169-346 computeIntersections,
src/lightSample.h:59-139 occulusionTest).

Two implementations walk the triangle BVH, chosen by platform
(`resolve_traversal`):

- on the GPU, the per-ray kernel of ops/traverse_kernel.py: one ray per
  thread following its own hit/miss links, as the reference does;
- on the CPU, and as the plain reference the kernel is tested against,
  the XLA walk below: ALL rays advance one node per `lax.while_loop`
  step; finished rays idle (node == -1).  Each step is two row-gathers
  from the packed tables — (N, 8) float32 node bounds and (N, 4) int32
  links — plus a vectorized AABB test and (for leaves, MAX_PRIM == 1) one
  triangle test.  The loop bound is dynamic (any ray active) with a
  static 4·N-node safety cap.

The MTBVH's 6 direction-sorted replicas keep rays front-to-back so the
`tempT > t_min` cutoff (reference: src/pathtrace.cu:252) prunes quickly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pathtracer.ops import traverse_kernel
from pathtracer.ops.intersect import ray_aabb, ray_triangle
from pathtracer.ops.traverse_kernel import DEAD_T, FLT_MAX
from pathtracer.scene.flatscene import FlatScene, SceneStatic
from pathtracer.scene.parser import CUBE, SPHERE


class Hit(NamedTuple):
    t: jnp.ndarray          # (N,) world distance; FLT_MAX = miss
    geom: jnp.ndarray       # (N,) int32 geom index, -1 = miss
    tri: jnp.ndarray        # (N,) int32 triangle index, -1 = analytic geom
    point: jnp.ndarray      # (N, 3)
    normal: jnp.ndarray     # (N, 3) geometric/interpolated normal (pre normal-map)
    uv: jnp.ndarray         # (N, 2)
    tangent: jnp.ndarray    # (N, 3)
    bitangent: jnp.ndarray  # (N, 3)


def _geom_t_soa(flat: FlatScene, gi: int, gtype: int, ox, oy, oz, dx, dy, dz):
    """SoA analytic test for one static geom.

    Returns (valid, t_world, (px,py,pz) object hit, (wx,wy,wz) world hit,
    (nx,ny,nz) OBJECT normal) as (N,) columns — all reduce-free
    elementwise math, so consecutive geom tests fuse into one XLA pass
    (tools/sweep_probe.py).  Callers that only need (valid, t) let DCE
    drop the rest (the occlusion sweep).  Formulas replicate
    ray_sphere/ray_cube bit-for-bit (reference: src/intersections.h:48-144,
    pull-back + world-t quirk at :27-29); the world normal is
    normalize(invt @ n_obj), applied ONCE by the caller via a
    winner-selected invt (computing it per geom — the round-2 form —
    cost cornell ~5% end to end).
    """
    from pathtracer.ops.intersect import (
        mat_rows,
        normalize_cols,
        xform_point_cols,
        xform_vector_cols,
    )

    inv = mat_rows(flat.geom_inv[gi])
    tr = mat_rows(flat.geom_transform[gi])
    rox, roy, roz = xform_point_cols(inv, ox, oy, oz)
    rdx, rdy, rdz = normalize_cols(*xform_vector_cols(inv, dx, dy, dz))
    if gtype == SPHERE:
        # reference: src/intersections.h:102-144
        vdd = rox * rdx + roy * rdy + roz * rdz
        rad = vdd * vdd - ((rox * rox + roy * roy + roz * roz) - 0.25)
        root = jnp.sqrt(jnp.maximum(rad, 0.0))
        t1, t2 = -vdd + root, -vdd - root
        valid = (rad >= 0.0) & ~((t1 < 0.0) & (t2 < 0.0))
        t_obj = jnp.where((t1 > 0.0) & (t2 > 0.0),
                          jnp.minimum(t1, t2), jnp.maximum(t1, t2))
    else:
        # cube slabs; div-by-zero → ±inf as in the reference
        # (src/intersections.h:58-76)
        i1x, i2x = (-0.5 - rox) / rdx, (0.5 - rox) / rdx
        i1y, i2y = (-0.5 - roy) / rdy, (0.5 - roy) / rdy
        i1z, i2z = (-0.5 - roz) / rdz, (0.5 - roz) / rdz
        gx = jnp.minimum(i1x, i2x)
        gy = jnp.minimum(i1y, i2y)
        gz = jnp.minimum(i1z, i2z)
        gx = jnp.where(gx > 0.0, gx, -1e38)
        gy = jnp.where(gy > 0.0, gy, -1e38)
        gz = jnp.where(gz > 0.0, gz, -1e38)
        tmin = jnp.maximum(gx, jnp.maximum(gy, gz))
        tmax = jnp.minimum(jnp.maximum(i1x, i2x),
                           jnp.minimum(jnp.maximum(i1y, i2y),
                                       jnp.maximum(i1z, i2z)))
        valid = (tmax >= tmin) & (tmax > 0.0)
        t_obj = jnp.where(tmin <= 0.0, tmax, tmin)
    # pull-back + world-t quirk (reference: src/intersections.h:27-29)
    px = rox + (t_obj - 1e-4) * rdx
    py = roy + (t_obj - 1e-4) * rdy
    pz = roz + (t_obj - 1e-4) * rdz
    wx, wy, wz = xform_point_cols(tr, px, py, pz)
    ex, ey, ez = wx - ox, wy - oy, wz - oz
    t = jnp.sqrt(jnp.maximum(ex * ex + ey * ey + ez * ez, 0.0))
    if gtype == SPHERE:
        # object normal = hit point (direction from center)
        nx, ny, nz = px, py, pz
    else:
        # slab-entry axis basis * sign (reference: intersections.h:66;
        # argmax/argmin tie-break = FIRST index, like jnp.argmax)
        sx = jnp.where(i2x < i1x, 1.0, -1.0)
        sy = jnp.where(i2y < i1y, 1.0, -1.0)
        sz = jnp.where(i2z < i1z, 1.0, -1.0)
        inside = tmin <= 0.0
        tbx = jnp.maximum(i1x, i2x)
        tby = jnp.maximum(i1y, i2y)
        amin_x = gx >= tmin
        amin_y = ~amin_x & (gy >= tmin)
        amax_x = tbx <= tmax
        amax_y = ~amax_x & (tby <= tmax)
        ax_x = jnp.where(inside, amax_x, amin_x)
        ax_y = jnp.where(inside, amax_y, amin_y)
        sign = jnp.where(ax_x, sx, jnp.where(ax_y, sy, sz))
        nx = jnp.where(ax_x, sign, 0.0)
        ny = jnp.where(ax_y, sign, 0.0)
        nz = jnp.where(ax_x | ax_y, 0.0, sign)
    return valid, t, (px, py, pz), (wx, wy, wz), (nx, ny, nz)


def _geoms_closest(flat: FlatScene, static: SceneStatic, o, d):
    """Brute-force analytic geoms (reference: src/pathtrace.cu:211-235).

    Two-phase SoA sweep, fully unrolled over the (static) geom list, all
    math on (N,) component COLUMNS with zero cross-lane reduces: every
    dot/argmax over the (N,3) minor axis is a reduce that ends its XLA
    fusion, and the AoS sweep decomposed into ~50 small fusions per
    bounce, each a full HBM round trip (tools/sweep_probe.py: the SoA
    form is 3x faster on the real cornell geometry at 640k rays).

    Phase 1 sweeps per geom, carrying (t, winner id, world hit, object
    normal) columns inside one fused elementwise chain; phase 2 applies
    the winner's invt ONCE via winner-selected matrix scalars (select
    chains over static matrices — never a gathered (N,4,4)).
    """
    from pathtracer.ops.intersect import (
        normalize_cols,
        xform_vector_cols,
    )

    N = o.shape[0]
    # fusion fence: keeps XLA from fusing the reduce-free sweep into its
    # producers and consumers as one large fusion whose live ranges spill.
    # It was chosen for the machine this code was first tuned on; whether
    # it pays on the GPU is still to be measured (ROADMAP D5).
    o, d = jax.lax.optimization_barrier((o, d))
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    zero = jnp.zeros((N,), jnp.float32)
    t_min = jnp.full((N,), FLT_MAX, jnp.float32)
    geom = jnp.full((N,), -1, jnp.int32)
    # winner's world hit + OBJECT normal (computed per geom in the fused
    # sweep — the ops the AoS form also paid — and carried as columns)
    wx_w = wy_w = wz_w = zero
    nxc = nyc = nzc = zero

    sweep = [
        (gi, gt) for gi, gt in enumerate(static.geom_types)
        if gt in (SPHERE, CUBE)
    ]

    for gi, gtype in sweep:
        valid, t, _, (wx, wy, wz), (nx, ny, nz) = _geom_t_soa(
            flat, gi, gtype, ox, oy, oz, dx, dy, dz
        )
        better = valid & (t > 0.0) & (t < t_min)
        t_min = jnp.where(better, t, t_min)
        geom = jnp.where(better, gi, geom)
        wx_w = jnp.where(better, wx, wx_w)
        wy_w = jnp.where(better, wy, wy_w)
        wz_w = jnp.where(better, wz, wz_w)
        nxc = jnp.where(better, nx, nxc)
        nyc = jnp.where(better, ny, nyc)
        nzc = jnp.where(better, nz, nzc)

    if not sweep:
        return (t_min, geom, jnp.zeros((N, 3), jnp.float32),
                jnp.zeros((N, 3), jnp.float32))

    # ---- winner world normal: ONE normalize(invt @ n_obj), with invt's
    # 9 scalars selected by the winner id (8-deep where chains over
    # STATIC scalars — the selected values equal the winner's matrix
    # exactly, so this is bit-identical to the per-geom transform the
    # AoS form applied 8 times) ----
    def sel_scalar(vals):
        out = vals[0][1]
        for gi, v in vals[1:]:
            out = jnp.where(geom == gi, v, out)
        return out

    invt_sel = tuple(
        tuple(
            sel_scalar([(gi, flat.geom_invt[gi][i, j]) for gi, _ in sweep])
            for j in range(3)  # vector xform: translation column unused
        )
        for i in range(3)
    )
    nwx, nwy, nwz = normalize_cols(
        *xform_vector_cols(invt_sel, nxc, nyc, nzc)
    )
    found = geom >= 0
    point = jnp.stack(
        [jnp.where(found, wx_w, 0.0), jnp.where(found, wy_w, 0.0),
         jnp.where(found, wz_w, 0.0)], axis=1,
    )
    normal = jnp.stack(
        [jnp.where(found, nwx, 0.0), jnp.where(found, nwy, 0.0),
         jnp.where(found, nwz, 0.0)], axis=1,
    )
    return jax.lax.optimization_barrier((t_min, geom, point, normal))


def _mtbvh_offset(static: SceneStatic, d):
    """Direction-octant tree select (reference: src/pathtrace.cu:241-246)."""
    ad = jnp.abs(d)
    axis = jnp.where(
        (ad[..., 0] > ad[..., 1]) & (ad[..., 0] > ad[..., 2]),
        0,
        jnp.where(ad[..., 1] > ad[..., 2], 1, 2),
    )
    comp = jnp.take_along_axis(d, axis[..., None], axis=-1)[..., 0]
    octant = axis + jnp.where(comp > 0.0, 0, 3)
    return (octant * static.num_bvh_nodes).astype(jnp.int32)


def _bvh_closest(flat: FlatScene, static: SceneStatic, o, d, t_min, tri, u, v):
    """Stackless threaded walk (reference: src/pathtrace.cu:236-279)."""
    N = o.shape[0]
    num_nodes = static.num_bvh_nodes
    max_prim = max(static.max_prim, 1)
    offset = (
        _mtbvh_offset(static, d)
        if static.num_bvh_trees == 6
        else jnp.zeros((N,), jnp.int32)
    )
    node0 = jnp.zeros((N,), jnp.int32)
    max_steps = 4 * num_nodes + 4

    def cond(state):
        step, node, *_ = state
        return jnp.any(node != -1) & (step < max_steps)

    def body(state):
        step, node, t_min, tri, u, v = state
        active = node != -1
        nidx = offset + jnp.clip(node, 0, num_nodes - 1)
        nf = flat.bvh_f32[nidx]
        ni = flat.bvh_i32[nidx]
        box_hit, t_enter = ray_aabb(nf[:, 0:3], nf[:, 3:6], o, d)
        box_ok = box_hit & (t_enter <= t_min)
        is_leaf = (ni[:, 1] - ni[:, 0]) <= max_prim

        # static unroll over the leaf span (reference: src/pathtrace.cu:256)
        for k in range(max_prim):
            tidx = jnp.clip(ni[:, 0] + k, 0, flat.tri_data.shape[0] - 1)
            trow = flat.tri_data[tidx]
            th, tt, tu, tv = ray_triangle(trow[:, 0:3], trow[:, 3:6], trow[:, 6:9], o, d)
            in_leaf = ni[:, 0] + k < ni[:, 1]
            take = active & box_ok & is_leaf & in_leaf & th & (tt < t_min)

            t_min = jnp.where(take, tt, t_min)
            tri = jnp.where(take, tidx, tri)
            u = jnp.where(take, tu, u)
            v = jnp.where(take, tv, v)

        nxt = jnp.where(box_ok, ni[:, 2], ni[:, 3])  # hit else miss link
        node = jnp.where(active, nxt, -1)
        return step + 1, node, t_min, tri, u, v

    _, _, t_min, tri, u, v = jax.lax.while_loop(
        cond, body, (jnp.int32(0), node0, t_min, tri, u, v)
    )
    return t_min, tri, u, v


def _brute_closest(flat: FlatScene, o, d, t_min, tri, u, v):
    """No-BVH triangle sweep (the reference's USE_BVH=0 branch,
    reference: src/pathtrace.cu:281-296): every ray tests every triangle
    via a `lax.fori_loop` — a debug/parity mode, not a fast path."""

    def body(i, state):
        t_min, tri, u, v = state
        trow = flat.tri_data[i]
        th, tt, tu, tv = ray_triangle(
            trow[None, 0:3], trow[None, 3:6], trow[None, 6:9], o, d
        )
        take = th & (tt < t_min)
        return (
            jnp.where(take, tt, t_min),
            jnp.where(take, i, tri),
            jnp.where(take, tu, u),
            jnp.where(take, tv, v),
        )

    return jax.lax.fori_loop(
        0, flat.tri_data.shape[0], body, (t_min, tri, u, v)
    )


TRAVERSALS = ("auto", "xla")


def resolve_traversal(choice: str, platform: str) -> str:
    """Which BVH walk a triangle scene takes on `platform` ("gpu", "cpu"):
    "kernel" (the per-ray kernel) or "xla".

    "auto" is the kernel on the GPU and the XLA walk elsewhere.  "xla"
    forces the XLA walk (the plain reference).
    """
    if choice not in TRAVERSALS:
        raise ValueError(f"traversal {choice!r} not in {TRAVERSALS}")
    if choice == "auto":
        return "kernel" if platform == "gpu" else "xla"
    return choice


def _kernel_args(static: SceneStatic) -> dict:
    return dict(
        num_nodes=static.num_bvh_nodes, num_trees=static.num_bvh_trees,
        max_prim=static.max_prim,
    )


def closest_hit(
    flat: FlatScene, static: SceneStatic, o, d, alive=None,
    use_bvh: bool = True, traversal: str = "xla",
) -> Hit:
    """Full-scene closest hit (geoms + triangles).

    `traversal` ("xla" or "kernel", see `resolve_traversal`)
    picks the triangle BVH walk; `alive` lets the kernel skip dead lanes.
    `use_bvh=False` is the reference's USE_BVH=0 brute-force triangle
    sweep (reference: src/utilities.h:22).
    """
    N = o.shape[0]
    t_min, geom, point, normal = _geoms_closest(flat, static, o, d)
    tri = jnp.full((N,), -1, jnp.int32)
    u = jnp.zeros((N,), jnp.float32)
    v = jnp.zeros((N,), jnp.float32)
    uv = jnp.zeros((N, 2), jnp.float32)
    tangent = jnp.zeros((N, 3), jnp.float32)
    bitangent = jnp.zeros((N, 3), jnp.float32)

    if static.num_tris > 0 and not use_bvh:
        t_min, tri, u, v = _brute_closest(flat, o, d, t_min, tri, u, v)
    elif static.num_tris > 0 and traversal != "xla":
        t_init = t_min if alive is None else jnp.where(alive, t_min, DEAD_T)
        t_k, tri, u, v = traverse_kernel.closest_hit_kernel(
            flat.bvh_f32, flat.bvh_i32, flat.tri_data, o, d, t_init,
            **_kernel_args(static),
        )
        t_min = jnp.where(tri >= 0, t_k, t_min)
    elif static.num_tris > 0:
        t_min, tri, u, v = _bvh_closest(flat, static, o, d, t_min, tri, u, v)

    if static.num_tris > 0:
        got_tri = tri >= 0
        tidx = jnp.clip(tri, 0, flat.tri_data.shape[0] - 1)
        trow = flat.tri_data[tidx]
        w0 = (1.0 - u - v)[..., None]
        uw, vw = u[..., None], v[..., None]
        # barycentric position/normal/uv (reference: src/pathtrace.cu:270-274)
        p_tri = w0 * trow[:, 0:3] + uw * trow[:, 3:6] + vw * trow[:, 6:9]
        n_tri = w0 * trow[:, 9:12] + uw * trow[:, 12:15] + vw * trow[:, 15:18]
        uv_tri = w0 * trow[:, 18:20] + uw * trow[:, 20:22] + vw * trow[:, 22:24]
        gm = got_tri[..., None]
        point = jnp.where(gm, p_tri, point)
        normal = jnp.where(gm, n_tri, normal)
        uv = jnp.where(gm, jnp.clip(uv_tri, 0.0, 1.0), uv)
        tangent = jnp.where(gm, trow[:, 24:27], tangent)
        bitangent = jnp.where(gm, trow[:, 27:30], bitangent)
        # geom id from the gathered row (col 30): no second gather
        geom = jnp.where(got_tri, trow[:, 30].astype(jnp.int32), geom)

    return Hit(t_min, geom, tri, point, normal, uv, tangent, bitangent)


def occlusion_test(
    flat: FlatScene, static: SceneStatic, ori, dir, des, enabled=None,
    use_bvh: bool = True, traversal: str = "xla",
):
    """Shadow query: is the segment ori→des blocked?

    reference: src/lightSample.h:59-139 — brute-force geoms with window
    (t < minT-1e-5 && |t-minT| > 1e-2), then BVH triangles with window
    (t < minT-1e-5 && |t-minT| > 1e-4).  Lanes with `enabled` False are
    never traced and report unblocked unless an analytic geom blocks them.
    """
    N = ori.shape[0]
    min_t = jnp.sqrt(jnp.maximum(jnp.sum((des - ori) ** 2, -1), 0.0))
    occluded = jnp.zeros((N,), bool)

    # SoA analytic sweep (same column form as _geoms_closest phase 1;
    # the unused hit-point outputs are dead-code-eliminated)
    ox, oy, oz = ori[:, 0], ori[:, 1], ori[:, 2]
    dx, dy, dz = dir[:, 0], dir[:, 1], dir[:, 2]
    for gi, gtype in enumerate(static.geom_types):
        if gtype not in (SPHERE, CUBE):
            continue
        valid, t, _, _, _ = _geom_t_soa(flat, gi, gtype, ox, oy, oz, dx, dy, dz)
        blocked = valid & (t > 0.0) & (min_t - 1e-5 > t) & (jnp.abs(t - min_t) > 1e-2)
        occluded = occluded | blocked

    if static.num_tris == 0:
        return occluded
    if not use_bvh:
        # USE_BVH=0 shadow sweep.  The reference's no-BVH occlusion branch
        # `return false`s on the first hit (reference: src/lightSample.h:125-135)
        # — an inverted-result dead-code bug; we keep the BVH branch's
        # blocked semantics and window instead of replicating it.
        enabled_mask = (
            jnp.ones((N,), bool) if enabled is None else enabled
        ) & ~occluded

        def brute_body(i, occluded):
            trow = flat.tri_data[i]
            th, tt, _, _ = ray_triangle(
                trow[None, 0:3], trow[None, 3:6], trow[None, 6:9], ori, dir
            )
            blocked = (
                enabled_mask & th & (min_t - 1e-5 > tt)
                & (jnp.abs(tt - min_t) > 1e-4)
            )
            return occluded | blocked

        return jax.lax.fori_loop(
            0, flat.tri_data.shape[0], brute_body, occluded
        )
    trace = ~occluded if enabled is None else enabled & ~occluded
    if traversal != "xla":
        blocked = traverse_kernel.occlusion_kernel(
            flat.bvh_f32, flat.bvh_i32, flat.tri_data, ori, dir,
            jnp.where(trace, min_t, DEAD_T),
            **_kernel_args(static),
        )
        return occluded | blocked
    return occluded | _bvh_occluded(flat, static, ori, dir, min_t, trace)


def _bvh_occluded(flat: FlatScene, static: SceneStatic, ori, dir, min_t, trace):
    """XLA any-hit walk over the lanes in `trace` (reference:
    src/lightSample.h:94-123)."""
    N = ori.shape[0]
    num_nodes = static.num_bvh_nodes
    offset = (
        _mtbvh_offset(static, dir)
        if static.num_bvh_trees == 6
        else jnp.zeros((N,), jnp.int32)
    )
    start_node = jnp.where(trace, 0, -1)  # untraced lanes idle
    max_steps = 4 * num_nodes + 4
    max_prim = max(static.max_prim, 1)

    def cond(state):
        step, node, _ = state
        return jnp.any(node != -1) & (step < max_steps)

    def body(state):
        step, node, occluded = state
        active = node != -1
        nidx = offset + jnp.clip(node, 0, num_nodes - 1)
        nf = flat.bvh_f32[nidx]
        ni = flat.bvh_i32[nidx]
        box_hit, t_enter = ray_aabb(nf[:, 0:3], nf[:, 3:6], ori, dir)
        box_ok = box_hit & (t_enter <= min_t)
        is_leaf = (ni[:, 1] - ni[:, 0]) <= max_prim

        blocked = jnp.zeros_like(occluded)
        for k in range(max_prim):
            tidx = jnp.clip(ni[:, 0] + k, 0, flat.tri_data.shape[0] - 1)
            trow = flat.tri_data[tidx]
            th, tt, _, _ = ray_triangle(
                trow[:, 0:3], trow[:, 3:6], trow[:, 6:9], ori, dir
            )
            blocked = blocked | (
                active
                & box_ok
                & is_leaf
                & (ni[:, 0] + k < ni[:, 1])
                & th
                & (min_t - 1e-5 > tt)
                & (jnp.abs(tt - min_t) > 1e-4)
            )
        occluded = occluded | blocked

        nxt = jnp.where(box_ok, ni[:, 2], ni[:, 3])
        node = jnp.where(active & ~blocked, nxt, -1)  # early-out on block
        return step + 1, node, occluded

    _, _, occluded = jax.lax.while_loop(
        cond, body, (jnp.int32(0), start_node, jnp.zeros((N,), bool))
    )
    return occluded
