"""Wavefront path-tracing integrator (BSDF / direct-light / MIS modes).

Rebuild of the reference's render loop + shading kernels
(reference: src/pathtrace.cu:637-816 pathtrace, :135-163 raygen,
:405-498 PTkernel, :348-403 DirectLiPTkernel, :500-588 MisPTkernel).

Architecture (SURVEY.md §7): a FIXED-SHAPE ray pool of W·H lanes (one per
pixel), iterated with `lax.while_loop` over bounce depth.  Dead lanes are
masked instead of compacted, so there are no host round-trips per bounce —
the reference's `compact_rays` costs 2 cudaMemcpy D2H per call, twice per
bounce (reference: src/pathtrace.cu:614-631,727,789).  The loop exits as
soon as every lane is dead (on-device `jnp.any`), matching the reference's
`num_paths == 0` exit without the sync.

Radiance accumulates on the RAY (`contrib` rides through per-bounce
sorts) and folds into the image once per iteration: a plain elementwise
add when unsorted (lane == pixel), one scatter-add when sorted.

Physics conventions replicated exactly:
- camera AA jitter (r-0.5) and pixel→direction mapping
  (reference: src/pathtrace.cu:149-154)
- env-map radiance added on miss at every depth, rays killed
  (reference: src/pathtrace.cu:303-311)
- normal mapping via per-triangle TBN gated on tangent validity
  (reference: src/pathtrace.cu:323-340)
- ray-offset epsilons: dielectric 1e-3·(sign-aligned normal), others
  1e-4·new_dir (reference: src/pathtrace.cu:481,577)
- paths that exhaust depth are discarded with NO contribution
  (reference: src/pathtrace.cu:492-496)
- NaN/Inf scrubbed before every accumulation (processNAN)
- MIS: prevPdf carries the BSDF pdf (-1 for delta), light hits weighted by
  powerHeuristic(prevPdf, lightPDF), NEE term weighted by
  powerHeuristic(lightPdf, bsdfPdf) (reference: src/pathtrace.cu:545-571)
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pathtracer.ops import math as m
from pathtracer.ops.lights import light_pdf, light_sample
from pathtracer.ops.materials import (
    material_by_geom,
    pdf_eval,
    bsdf_eval,
    scatter_sample,
)
from pathtracer.ops.texture import bilinear_sample_u32_meta
from pathtracer.ops.traverse import closest_hit, resolve_traversal
from pathtracer.scene.flatscene import FlatScene, SceneStatic
from pathtracer.scene.parser import DIELECTRIC, LIGHT, SPHERE
from pathtracer.utils import rng
from pathtracer.utils.config import RenderOptions, SampleMode


class CameraArrays(NamedTuple):
    """Traced camera state (orbiting does not retrigger compilation)."""

    position: jnp.ndarray      # (3,)
    view: jnp.ndarray          # (3,)
    up: jnp.ndarray            # (3,)
    right: jnp.ndarray         # (3,)
    pixel_length: jnp.ndarray  # (2,)


def camera_rays(
    cam: CameraArrays, width: int, height: int, key, iteration, pixel0=0,
    local_n=None, pixel_xy=None,
):
    """Per-pixel AA-jittered primary rays (reference: src/pathtrace.cu:135-163).

    `width`/`height` are the FULL image resolution (they center the film
    plane); `pixel0` + `local_n` select this shard's contiguous pixel range
    (defaults: the whole frame).  `pixel_xy` optionally overrides the
    lane→pixel mapping with precomputed (xs, ys) arrays — the spatial
    swizzle that keeps neighbouring lanes on neighbouring pixels.
    """
    n = local_n if local_n is not None else width * height
    idx = pixel0 + jnp.arange(n, dtype=jnp.int32)
    if pixel_xy is not None:
        x, y = pixel_xy
    else:
        x = (idx % width).astype(jnp.float32)
        y = (idx // width).astype(jnp.float32)
    r = rng.pixel_uniforms(key, iteration, 0, rng.STAGE_CAMERA, idx, 2)
    px = x + (r[:, 0] - 0.5) - width * 0.5
    py = y + (r[:, 1] - 0.5) - height * 0.5
    d = m.normalize(
        cam.view[None, :]
        - cam.right[None, :] * (cam.pixel_length[0] * px)[:, None]
        - cam.up[None, :] * (cam.pixel_length[1] * py)[:, None]
    )
    o = jnp.broadcast_to(cam.position, (n, 3))
    return o, d


# Dead-lane sort sentinel (must exceed every live sort key: octant/cell
# keys are < 2^12).
_DEAD_KEY = 1 << 20

SWIZZLE_BLOCK = 32  # must match integrator/render.swizzle_map's block
SHRINK_TILE = 128  # shrunk pool sizes round up to this many lanes


def swizzle_xy_from_lane(l, width: int, block: int = SWIZZLE_BLOCK):
    """Arithmetic inverse of integrator/render.swizzle_map for films that
    tile exactly into block² squares: lane l's swizzle key IS l (the key
    map is a bijection onto [0, n)), so the pixel is recovered by
    unpacking the key — no (N,)-table gathers in the regeneration refill
    (tests pin this against the argsort-built map)."""
    b2 = block * block
    bx = width // block
    blk = l // b2
    r = l % b2
    x = (blk % bx) * block + r % block
    y = (blk // bx) * block + r // block
    return x.astype(jnp.float32), y.astype(jnp.float32)
# env-miss flag, packed into the lane column's high bit: a lane that dies
# by env miss needs only ONE bit of extra state, because its radiance
# scale at death IS its (frozen) `color` — carrying a separate (N, 3)
# env_scale through every per-bounce sort cost 3 sort operands for one bit
_ENV_MISS_BIT = jnp.int32(1 << 30)
_LANE_MASK = jnp.int32((1 << 30) - 1)


class _BounceState(NamedTuple):
    depth: jnp.ndarray  # SCALAR lap counter (== per-lane bounce depth in
    # the classic one-sample pools; just the lap budget under regeneration)
    o: jnp.ndarray
    d: jnp.ndarray
    color: jnp.ndarray
    contrib: jnp.ndarray  # radiance accumulated BY THIS RAY (rides the ray
    # through sorts; scattered into img once per iteration, not per bounce)
    prev_pdf: jnp.ndarray
    alive: jnp.ndarray
    lane: jnp.ndarray  # this ray's image slot (rays migrate when sorted);
    # high bit = died-by-env-miss flag (the deferred env lookup in
    # finish_state scales the radiance by the lane's frozen `color`)
    img: jnp.ndarray
    rays_traced: jnp.ndarray  # throughput metric (primary+bounce+shadow rays)
    meta: jnp.ndarray | None = None  # regeneration only: per-lane packed
    # (sample offset << 8 | bounce depth) — lanes run DIFFERENT samples at
    # different depths inside one dispatch, so depth is no longer derivable
    # from the scalar lap counter (None on the classic paths: one less sort
    # operand there)


def _apply_normal_map(hit, params):
    """reference: src/pathtrace.cu:323-340."""
    n = m.normalize(hit.normal)
    local = m.normalize(params.normal_map - 0.5)
    t = hit.tangent
    use_tbn = (m.dot(t, t) > 1e-3) & (jnp.abs(local[:, 2] - 1.0) > 1e-5)
    b2 = m.normalize(m.cross(n, t))
    t2 = m.normalize(m.cross(b2, n))
    mapped = m.normalize(
        local[:, 0:1] * t2 + local[:, 1:2] * b2 + local[:, 2:3] * n
    )
    return jnp.where(use_tbn[..., None], mapped, n)


def make_render_iteration(
    static: SceneStatic,
    opts: RenderOptions,
    width: int,
    height: int,
    local_rows: int | None = None,
    pixel_xy=None,
    regen_k: int = 1,
):
    """Build the jittable one-iteration render function.

    Returns f(flat, cam, img, iteration, key, pixel0=0) ->
    (img, rays_traced, traced_depth) — traced_depth is the number of bounce
    laps actually executed (the reference's live guiData->TracedDepth,
    reference: src/pathtrace.cu:793-796).
    `img` is the running radiance SUM over iterations, (local_rows·W, 3)
    float32 (display divides by the iteration count, like the reference's
    dev_image).  `width`/`height` are the FULL film resolution;
    `local_rows` (default: height) is how many contiguous rows this pool
    covers, starting at pixel `pixel0` — the device-mesh sharding hook.

    `regen_k > 1` builds the CROSS-ITERATION RAY-REGENERATION variant
    instead: f(flat, cam, img, it0, key, nk, pixel0=0) renders `nk`
    (traced, <= regen_k) samples per pixel in ONE persistent pool.  When a
    lane's path dies at a bounce it is immediately refilled with the
    camera ray for that pixel's NEXT sample index, so every per-bounce
    fixed cost — kernel launches, the multi-operand sort, material/atlas
    taps — amortizes over a near-full-live pool instead of the liveness
    tails of the one-sample pools.  It plays the part of the reference's
    stream compaction, which keeps the GPU busy only on live paths every
    bounce (reference:
    src/pathtrace.cu:614-631,727,789).  Physics is EXACT: the
    (pixel, sample, bounce, stage) RNG streams are identical to the
    sequential renderer's (utils/rng.pixel_uniforms packs per-lane
    iteration/depth into the threefry counter), so the same sample set is
    integrated — only float-accumulation order changes (regen sums a
    pixel's samples on the lane before the one image add).
    """
    n = width * (local_rows if local_rows is not None else height)
    mode = opts.sample_mode
    regen = int(regen_k) > 1
    if regen and (mode == SampleMode.DIRECT_LI or bool(opts.show_normal)):
        raise ValueError(
            "ray regeneration applies to the multi-bounce BSDF/MIS "
            "integrators (DIRECT_LI / show_normal pools die after one "
            "bounce by construction)"
        )
    if regen and static.trace_depth > 255:
        raise ValueError(
            "ray regeneration packs per-lane bounce depth into 8 bits "
            f"(trace depth {static.trace_depth} > 255)"
        )
    trace_depth = static.trace_depth
    use_bvh = bool(opts.use_bvh)
    # the triangle BVH walk for this platform (ops/traverse.resolve_traversal)
    traversal = resolve_traversal(opts.traversal, jax.default_backend())
    show_normal = bool(opts.show_normal)
    # per-bounce ray sorting (the counterpart of the reference's stream
    # compaction, reference: src/pathtrace.cu:614-631): rays reorder by
    # (alive, direction octant, origin cell) so neighbouring lanes trace
    # similar paths after the first bounce and dead rays cluster at the
    # back.  The sort is one multi-operand lax.sort; it is on for mesh
    # scenes, where traversal is expensive, and for textured scenes, whose
    # atlas taps run per lane whether the lane is alive or not (the sort's
    # dead-lane clustering plus the pool shrink cut the taps with liveness)
    sort_rays = bool(opts.compaction) and (
        static.num_tris >= 512 or any(static.tex_slots)
    )
    # straggler-phase pool-shrink ladder (see run-pool below).  Decoupled
    # from the per-bounce sort: analytic scenes never sort, but OPEN
    # analytic scenes (mis_test: 5 sphere lights over floating ramps, most lanes die to
    # the void by depth 2) still waste full-pool sweeps on dead lanes —
    # the shrink ladder alone fixes that, paying only one alive-major
    # sort per SHRINK BOUNDARY (2-3 per iteration), not per bounce.
    # Closed analytic scenes (cornell) exit the depth budget with high
    # liveness, so the shrink cond below never fires and the ladder
    # costs nothing at runtime.
    shrink_ok = bool(opts.pool_shrink) and (sort_rays or static.num_tris == 0)
    _ceil_tile = lambda v: -((-v) // SHRINK_TILE) * SHRINK_TILE
    # ladder entries are (pool_size, divisor): the level fires once
    # alive * divisor <= parent pool (i.e. the survivors FIT its pool).
    # An optional half level (divisor 2) leads for mesh scenes whose
    # liveness lingers in the 25-50% band (see RenderOptions.shrink_half);
    # the rest of the ladder quarters as before.
    shrink_sizes: list[tuple[int, int]] = []
    _cur = n
    _divs = [4] * max(int(opts.shrink_levels), 0)
    if bool(opts.shrink_half) and sort_rays:
        _divs = [2] + _divs  # the half level rides ON TOP of shrink_levels
    for _f in _divs:
        if not shrink_ok:
            break
        _nxt = _ceil_tile(max(_cur // _f, 1))
        if not 0 < _nxt < _cur:
            break
        shrink_sizes.append((_nxt, _f))
        _cur = _nxt
    env_nee = bool(opts.env_importance) and static.env_map_id >= 0
    # Is NEE capable of a nonzero contribution AT ALL in this scene?  The
    # reference's lightSample has branches only for triangle and sphere
    # lights — CUBE area lights are listed but never sampled (pdf stays 0,
    # reference: src/lightSample.h:186-234), so a scene whose lights are
    # all cubes (classic cornell) does provably-zero NEE work every
    # bounce: light pick, cone/area math, a full shadow-occlusion pass,
    # and two BSDF dispatches, all multiplied by emit == 0.  Compile the
    # whole block out statically (output-identical; the MIS light-hit
    # weighting via light_pdf is unaffected and stays).
    nee_live = (
        static.num_lights > len(static.analytic_lights)  # triangle lights
        or any(g == SPHERE for (_, _, g) in static.analytic_lights)
        or env_nee
    )
    # pool→pixel map (spatial swizzle); identity when pixel_xy is None
    xs_ys = pixel_xy

    def _sort_state(flat, state: _BounceState) -> _BounceState:
        sb = static.scene_bounds  # static → folds to constants
        bmin = jnp.array(sb[0:3], jnp.float32)
        inv_ext = 7.999 / jnp.maximum(
            jnp.array(sb[3:6], jnp.float32) - bmin, 1e-6
        )
        cell = jnp.clip(((state.o - bmin) * inv_ext), 0.0, 7.999).astype(jnp.int32)
        octant = (
            (state.d[:, 0] > 0).astype(jnp.int32)
            + 2 * (state.d[:, 1] > 0).astype(jnp.int32)
            + 4 * (state.d[:, 2] > 0).astype(jnp.int32)
        )
        key = ((octant * 8 + cell[:, 0]) * 8 + cell[:, 1]) * 8 + cell[:, 2]
        key = jnp.where(state.alive, key, jnp.int32(_DEAD_KEY))  # dead → back
        # ONE multi-operand lax.sort carrying every per-ray field as 1D
        # columns: payloads ride the sort network, so there are no (N, 3)
        # row gathers.  Sort operands are pruned to the irreducible set — `alive` re-derives
        # from the sorted key, `remaining` from the scalar depth, env-miss
        # state from the lane flag bit, and prev_pdf is the constant -1
        # outside MIS mode — each dropped operand is one less 640k column
        # through the sort network
        cols = (
            state.o[:, 0], state.o[:, 1], state.o[:, 2],
            state.d[:, 0], state.d[:, 1], state.d[:, 2],
            state.color[:, 0], state.color[:, 1], state.color[:, 2],
            state.contrib[:, 0], state.contrib[:, 1], state.contrib[:, 2],
            state.lane,
        )
        if regen:  # per-lane (sample offset, bounce depth) rides the ray
            cols = cols + (state.meta,)
        if mode == SampleMode.MIS:
            cols = cols + (state.prev_pdf,)
        out = jax.lax.sort((key,) + cols, num_keys=1, is_stable=True)
        st3 = lambda i: jnp.stack(out[i : i + 3], axis=1)
        nxt_i = 14  # first optional operand slot after the 13 fixed + key
        meta_out = state.meta
        if regen:
            meta_out = out[nxt_i]
            nxt_i += 1
        return state._replace(
            o=st3(1), d=st3(4), color=st3(7), contrib=st3(10),
            lane=out[13],
            meta=meta_out,
            prev_pdf=out[nxt_i] if mode == SampleMode.MIS else state.prev_pdf,
            alive=out[0] < _DEAD_KEY,
        )

    # -- regeneration helpers ------------------------------------------------
    # when the film tiles exactly into 32x32 blocks the swizzle key is a
    # bijection and lane->pixel inverts ARITHMETICALLY (no xs/ys gathers
    # per regen lap); tests pin this against swizzle_map
    swz_arith = (
        pixel_xy is not None and width % SWIZZLE_BLOCK == 0
        and height % SWIZZLE_BLOCK == 0 and local_rows is None
    )

    def _lane_xy(l, pixel0):
        """Film (x, y) of original lane id `l` (post-sort lanes migrate, so
        this is how a regenerated ray finds its pixel)."""
        if xs_ys is None:
            idx = pixel0 + l
            return (
                (idx % width).astype(jnp.float32),
                (idx // width).astype(jnp.float32),
            )
        if swz_arith:
            return swizzle_xy_from_lane(l, width)
        return xs_ys[0][l], xs_ys[1][l]

    def _regen_rays(cam: CameraArrays, lane_ids, it_lane, key, pixel0):
        """Camera rays for refilled lanes — same mapping + AA jitter as
        camera_rays (reference: src/pathtrace.cu:135-163), with PER-LANE
        sample indices."""
        x, y = _lane_xy(lane_ids, pixel0)
        idx = pixel0 + lane_ids
        r = rng.pixel_uniforms(key, it_lane, 0, rng.STAGE_CAMERA, idx, 2)
        px = x + (r[:, 0] - 0.5) - width * 0.5
        py = y + (r[:, 1] - 0.5) - height * 0.5
        d = m.normalize(
            cam.view[None, :]
            - cam.right[None, :] * (cam.pixel_length[0] * px)[:, None]
            - cam.up[None, :] * (cam.pixel_length[1] * py)[:, None]
        )
        o = jnp.broadcast_to(cam.position, (lane_ids.shape[0], 3))
        return o, d

    def bounce_body(flat: FlatScene, key, iteration, pixel0, state: _BounceState,
                    pool_n: int = n, cam: CameraArrays = None, nk=None):
        depth = state.depth
        if sort_rays:
            # the sort costs the same at any liveness; once <25% survive,
            # the PREVIOUS order already clusters the dead lanes, so
            # re-sorting stops paying (straggler-dominated scenes run
            # their tail laps with a mostly-dead pool).  Results are
            # bit-identical either way: RNG keys on lane and contributions
            # ride the ray.
            every = max(int(opts.sort_every), 1)
            due = True if every == 1 else (depth % every) == 0
            worth_it = (depth == 0) | (
                due & (jnp.sum(state.alive.astype(jnp.int32)) * 4 > pool_n)
            )
            state = jax.lax.cond(
                worth_it, lambda s: _sort_state(flat, s), lambda s: s, state
            )
        alive = state.alive
        # RNG keying: classic pools key every lane on the scalar
        # (iteration, lap); the regeneration pool keys each lane on ITS
        # OWN (sample index, bounce depth) from the packed meta column —
        # bit-identical streams either way (rng.pixel_uniforms packs both
        # into the threefry counter).  MUST be read AFTER the sort above:
        # the r5 first cut read meta pre-sort and paired stale
        # (sample, depth) keys with post-sort lanes — caught by the
        # lane-history trace in tools/, now pinned by
        # tests/test_regen.py's lit-mesh cross checks.
        if regen:
            rng_it = iteration + (state.meta >> 8)
            rng_dp = state.meta & 0xFF
        else:
            rng_it, rng_dp = iteration, depth
        pixel_idx = pixel0 + (state.lane & _LANE_MASK)
        contrib = state.contrib
        hit = closest_hit(
            flat, static, state.o, state.d, alive=alive, use_bvh=use_bvh,
            traversal=traversal,
        )
        rays_traced = state.rays_traced + jnp.sum(alive.astype(jnp.int32))

        miss = hit.geom < 0
        img = state.img

        if show_normal:
            # SHOW_NORMAL debug view: every ray terminates at its first
            # intersection contributing normalize(normal) + 1 (the raw
            # geometric/interpolated normal, before normal mapping)
            # (reference: src/pathtrace.cu:298-301, src/utilities.h:27)
            viz = m.process_nan(m.normalize(hit.normal) + 1.0)
            contrib = contrib + jnp.where((alive & ~miss)[..., None], viz, 0.0)
            return state._replace(
                depth=depth + 1,
                contrib=contrib,
                alive=jnp.zeros_like(alive),
                rays_traced=rays_traced,
            )
        lane = state.lane
        if static.env_map_id >= 0:
            # DEFERRED env lookup: a lane takes this branch at most once
            # per iteration (it dies on miss), and its d/prev_pdf/color
            # freeze at death — so just FLAG the lane here (high bit of
            # the lane column: one sort operand instead of an (N, 3)
            # env_scale, whose value at death is the frozen `color`
            # anyway) and do the 4-tap bilinear gather + MIS pdf gather
            # ONCE per iteration in finish_state instead of once per
            # bounce for the whole pool (the gathers were the envbunny
            # bottleneck: ~4 gathers x pool x up-to-8 bounces)
            lane = jnp.where(alive & miss, lane | _ENV_MISS_BIT, lane)
        alive = alive & ~miss

        params = material_by_geom(flat, static, hit.geom, hit.uv)
        nrm = _apply_normal_map(hit, params)
        is_light = params.type == LIGHT
        is_delta = params.type == DIELECTRIC

        sc_rand = rng.pixel_uniforms(key, rng_it, rng_dp, rng.STAGE_SCATTER, pixel_idx, 3)
        srec = scatter_sample(params, nrm, state.d, sc_rand, present=static.material_types)
        pdf_ok = srec.pdf != 0.0

        if mode == SampleMode.DIRECT_LI:
            # reference: src/pathtrace.cu:348-403 — one NEE bounce, then stop
            add_light = alive & is_light
            contrib = contrib + jnp.where(
                add_light[..., None], m.process_nan(state.color * params.emit), 0.0
            )
            # rays_traced follows the REFERENCE's shadow-ray issuance rule
            # (bench convention "rays as the reference would issue them"):
            # DirectLi calls lightSample for every non-light hit and
            # occulusionTest runs unconditionally — even when the picked
            # light is an unsampleable cube (reference:
            # src/lightSample.h:238).  Delta lanes get no NEE in the
            # reference either, so those stay uncounted.
            nee_on = alive & ~is_light & ~is_delta
            rays_traced = rays_traced + jnp.sum(nee_on.astype(jnp.int32))
            if nee_live:  # provably-zero NEE compiled out otherwise
                li_rand = rng.pixel_uniforms(key, rng_it, rng_dp, rng.STAGE_LIGHT, pixel_idx, 4 if env_nee else 3)
                # delta (dielectric) lanes: bsdf_eval ≡ 0, so their NEE term
                # is zero — skip their shadow rays entirely (output-identical)
                lrec = light_sample(flat, static, hit.point, li_rand, include_env=env_nee, use_bvh=use_bvh, enabled=nee_on, traversal=traversal)
                wi = m.normalize(lrec.pos - hit.point)
                bsdf = bsdf_eval(params, nrm, state.d, wi, present=static.material_types)
                nee = (
                    state.color
                    * bsdf
                    * lrec.emit
                    * (jnp.maximum(m.dot(wi, nrm), 0.0) / lrec.pdf)[..., None]
                )
                add_nee = alive & ~is_light & (lrec.pdf > 0.0)
                contrib = contrib + jnp.where(add_nee[..., None], m.process_nan(nee), 0.0)
            return _BounceState(
                depth + 1,
                state.o,
                state.d,
                state.color,
                contrib,
                state.prev_pdf,
                jnp.zeros_like(alive),
                lane,
                img,
                rays_traced,
            )

        # --- light hit term ---
        light_color = state.color * srec.bsdf / jnp.maximum(srec.pdf, 1e-38)[..., None]
        if mode == SampleMode.MIS:
            lp = light_pdf(
                flat, static, state.o, hit.point, nrm, hit.tri, hit.geom,
                include_env=env_nee,
            )
            weight = jnp.where(
                state.prev_pdf > 0.0,
                m.power_heuristic(state.prev_pdf, lp),
                1.0,
            )
            light_color = light_color * weight[..., None]
        add_light = alive & pdf_ok & is_light
        contrib = contrib + jnp.where(add_light[..., None], m.process_nan(light_color), 0.0)

        cont = alive & pdf_ok & ~is_light

        # --- NEE term (MIS only, non-delta; compiled out when no
        # sampleable light exists — cube-light-only scenes) ---
        if mode == SampleMode.MIS:
            # reference-issuance shadow-ray count (see DirectLi note
            # above): MisPTkernel runs lightSample + its unconditional
            # occulusionTest for every continuing non-delta lane
            # (reference: src/pathtrace.cu:560-571, lightSample.h:238),
            # whether or not we statically resolved the term to zero
            rays_traced = rays_traced + jnp.sum((cont & ~is_delta).astype(jnp.int32))
        if mode == SampleMode.MIS and nee_live:
            li_rand = rng.pixel_uniforms(key, rng_it, rng_dp, rng.STAGE_LIGHT, pixel_idx, 4 if env_nee else 3)
            # the NEE term is masked to cont & ~is_delta below; skipping the
            # other lanes' shadow rays in the kernel is output-identical
            lrec = light_sample(flat, static, hit.point, li_rand, include_env=env_nee, use_bvh=use_bvh, enabled=cont & ~is_delta, traversal=traversal)
            wi = m.normalize(lrec.pos - hit.point)
            b_pdf = pdf_eval(params, nrm, state.d, wi, present=static.material_types)
            li_bsdf = bsdf_eval(params, nrm, state.d, wi, present=static.material_types)
            w = m.power_heuristic(lrec.pdf, b_pdf)
            nee = (
                w[..., None]
                * state.color
                * lrec.emit
                * li_bsdf
                * (jnp.maximum(m.dot(wi, nrm), 0.0) / lrec.pdf)[..., None]
            )
            add_nee = cont & ~is_delta
            contrib = contrib + jnp.where(add_nee[..., None], m.process_nan(nee), 0.0)

        # --- continuation ---
        offset_dir = jnp.where(
            (m.dot(srec.dir, nrm) > 0.0)[..., None], nrm, -nrm
        )
        new_o = hit.point + jnp.where(
            is_delta[..., None], 1e-3 * offset_dir, 1e-4 * srec.dir
        )
        throughput = (
            srec.bsdf
            * (jnp.abs(m.dot(srec.dir, nrm)) / jnp.maximum(srec.pdf, 1e-38))[..., None]
        )
        cm = cont[..., None]
        color = jnp.where(cm, state.color * throughput, state.color)
        o = jnp.where(cm, new_o, state.o)
        d = jnp.where(cm, srec.dir, state.d)
        prev_pdf = state.prev_pdf
        if mode == SampleMode.MIS:
            prev_pdf = jnp.where(
                cont, jnp.where(is_delta, -1.0, srec.pdf), prev_pdf
            )
        # depth budget: every lane alive at depth k has continued exactly k
        # times, so the reference's per-ray `remainingBounces` counter is
        # derivable from the scalar loop depth — one less pool field (and
        # one less sort operand).  Under regeneration lanes run different
        # samples at different depths, so the budget reads the meta column.
        alive = cont & ((rng_dp if regen else depth) + 1 < trace_depth)
        meta = state.meta

        if regen:
            # --- cross-iteration ray regeneration -----------------------
            # Refill lanes whose path just died with the camera ray for
            # their pixel's NEXT sample index.  Runs at the END of the
            # body so the invariant "dead lane == fully exhausted" holds
            # at every loop boundary (the shrink ladder's alive-count
            # conditions and the while cond rely on it).
            meta = jnp.where(cont, meta + 1, meta)  # continuing: depth+1
            it_ofs = meta >> 8
            can_regen = ~alive & (it_ofs < nk - 1)
            if static.env_map_id >= 0:
                # a dying env-missed lane must cash its DEFERRED env
                # radiance now — its d/color/prev_pdf are about to be
                # overwritten.  Same math as finish_state (which still
                # handles lanes that env-miss on their LAST sample).
                flagged = (lane & _ENV_MISS_BIT) != 0
                resolve = can_regen & flagged
                env_uv = m.sphere_to_plane(d)
                eoff, ew, eh, efmt = static.tex_rows[static.env_map_id]
                env_rad = bilinear_sample_u32_meta(
                    flat.atlas_u32, eoff, ew, eh, bool(efmt), env_uv
                )
                env_w = 1.0
                if mode == SampleMode.MIS and env_nee:
                    from pathtracer.ops.envmap import env_pdf as _env_pdf

                    l_eff = jnp.float32(static.num_lights + 1)
                    ep = _env_pdf(flat, static, d) / l_eff
                    env_w = jnp.where(
                        prev_pdf > 0.0, m.power_heuristic(prev_pdf, ep), 1.0
                    )[..., None]
                contrib = contrib + jnp.where(
                    resolve[..., None],
                    m.process_nan(color * env_rad * env_w), 0.0,
                )
                lane = jnp.where(resolve, lane & _LANE_MASK, lane)
            l_ids = lane & _LANE_MASK
            ro, rd = _regen_rays(
                cam, l_ids, iteration + it_ofs + 1, key, pixel0
            )
            rm = can_regen[..., None]
            o = jnp.where(rm, ro, o)
            d = jnp.where(rm, rd, d)
            color = jnp.where(rm, 1.0, color)
            if mode == SampleMode.MIS:
                prev_pdf = jnp.where(can_regen, -1.0, prev_pdf)
            meta = jnp.where(can_regen, (it_ofs + 1) << 8, meta)
            alive = alive | can_regen

        return _BounceState(
            depth + 1, o, d, color, contrib, prev_pdf,
            alive, lane, img, rays_traced, meta
        )

    def _run_loop(flat, cam, img, iteration, key, pixel0, nk=None):
        """Shared loop driver: initial pool + shrink-laddered while loops.

        `nk=None` is the classic one-sample iteration (lap budget
        trace_depth+1); a traced `nk` drives the regeneration pool for nk
        samples/pixel (budget nk·(trace_depth+1): each of a lane's nk
        samples runs at most trace_depth+1 laps, and laps interleave)."""
        o, d = camera_rays(
            cam, width, height, key, iteration, pixel0, local_n=n, pixel_xy=xs_ys
        )
        state = _BounceState(
            depth=jnp.int32(0),
            o=o,
            d=d,
            color=jnp.ones((n, 3), jnp.float32),
            contrib=jnp.zeros((n, 3), jnp.float32),
            prev_pdf=jnp.full((n,), -1.0, jnp.float32),
            alive=jnp.ones((n,), bool),
            lane=jnp.arange(n, dtype=jnp.int32),
            img=img,
            rays_traced=jnp.int32(0),
            meta=jnp.zeros((n,), jnp.int32) if regen else None,
        )
        lap_budget = (
            trace_depth + 1 if not regen else nk * (trace_depth + 1)
        )

        def cond(s: _BounceState):
            return jnp.any(s.alive) & (s.depth < lap_budget)

        # straggler-phase pool shrink: every stage of a bounce costs in
        # proportion to the pool, so a mostly-dead pool pays for its dead
        # lanes.  Each phase runs its pool while >25% of its lanes are alive; on
        # exit the survivors are sorted to the front (the existing
        # alive-major key) and the remaining bounces run in the next
        # statically-shaped pool (quarter, then sixteenth — straggler
        # tails on env scenes sit at a few % liveness for most of the
        # depth budget).  Bit-identical: RNG keys on lane, contributions
        # ride the ray, and the merged state un-permutes in finish_state.
        # Under regeneration a dead lane is a fully EXHAUSTED lane (regen
        # happens at the end of the bounce body), so the same alive-count
        # conditions compose: the ladder only fires in the final drain
        # where no sample remains to refill with.
        sizes = shrink_sizes

        def run_pool(s: _BounceState, pool_n: int, next_sizes) -> _BounceState:
            body = partial(bounce_body, flat, key, iteration, pixel0,
                           pool_n=pool_n, cam=cam, nk=nk)
            if not next_sizes:
                return jax.lax.while_loop(cond, body, s)
            nxt, div = next_sizes[0]

            def cond_l(st: _BounceState):
                # keep running this pool while the survivors would NOT fit
                # the next one (alive > pool/div ⇒ alive could exceed nxt)
                return cond(st) & (
                    jnp.sum(st.alive.astype(jnp.int32)) * div > pool_n
                )

            s = jax.lax.while_loop(cond_l, body, s)

            def shrink_phase(st: _BounceState) -> _BounceState:
                st = _sort_state(flat, st)  # live lanes to the front
                cut = lambda a: (
                    a[:nxt] if a is not None and a.shape[0] == pool_n else a
                )
                small = st._replace(
                    o=cut(st.o), d=cut(st.d), color=cut(st.color),
                    contrib=cut(st.contrib),
                    prev_pdf=cut(st.prev_pdf),
                    alive=cut(st.alive), lane=cut(st.lane),
                    meta=cut(st.meta),
                )
                small = run_pool(small, nxt, next_sizes[1:])
                cat = lambda sm, fu: (
                    jnp.concatenate([sm, fu[nxt:]], axis=0)
                    if fu is not None and fu.shape[0] == pool_n else sm
                )
                return st._replace(
                    depth=small.depth,
                    o=cat(small.o, st.o), d=cat(small.d, st.d),
                    color=cat(small.color, st.color),
                    contrib=cat(small.contrib, st.contrib),
                    prev_pdf=cat(small.prev_pdf, st.prev_pdf),
                    alive=cat(small.alive, st.alive),
                    lane=cat(small.lane, st.lane),
                    meta=cat(small.meta, st.meta),
                    rays_traced=small.rays_traced,
                )

            # predicate is the FULL loop condition: if the while exited on
            # the depth budget (closed scenes keep liveness high to the
            # end), the shrink ladder would sort + slice + merge for a
            # zero-trip small pool — pure waste; image-identical either
            # way (finish_state un-permutes by lane)
            return jax.lax.cond(cond(s), shrink_phase, lambda st: st, s)

        state = run_pool(state, n, sizes)
        return finish_state(state, flat), state.rays_traced, state.depth

    def render_iteration(
        flat: FlatScene, cam: CameraArrays, img, iteration, key, pixel0=0
    ):
        return _run_loop(flat, cam, img, iteration, key, pixel0)

    def render_batch(
        flat: FlatScene, cam: CameraArrays, img, it0, key, nk, pixel0=0
    ):
        """Regeneration entry: render samples it0 .. it0+nk-1 of every
        pixel in one persistent pool (nk is TRACED — one executable
        serves any batch size up to the compile-time regen_k)."""
        return _run_loop(flat, cam, img, it0, key, pixel0, nk=jnp.int32(nk))

    def start_state(flat: FlatScene, cam: CameraArrays, img, iteration, key, pixel0=0):
        """Staged-mode entry: build the initial wavefront (raygen only)."""
        o, d = camera_rays(
            cam, width, height, key, iteration, pixel0, local_n=n, pixel_xy=xs_ys
        )
        return _BounceState(
            depth=jnp.int32(0),
            o=o,
            d=d,
            color=jnp.ones((n, 3), jnp.float32),
            contrib=jnp.zeros((n, 3), jnp.float32),
            prev_pdf=jnp.full((n,), -1.0, jnp.float32),
            alive=jnp.ones((n,), bool),
            lane=jnp.arange(n, dtype=jnp.int32),
            img=img,
            rays_traced=jnp.int32(0),
        )

    def finish_state(state: _BounceState, flat: FlatScene = None):
        """Fold the per-ray contributions into the image once per
        iteration.  Env-missed lanes get their DEFERRED radiance lookup
        here (one 4-tap gather pass per iteration instead of one per
        bounce — d and prev_pdf are frozen at death so the lookup
        commutes).  Sorted pools un-permute via a lane-keyed multi-operand
        sort (lane is a permutation, so sorting by it IS the inverse
        permutation; tools/sort_bench.py times it against the (N,3)
        scatter-add).  Unsorted pools: lane i == pixel i, plain add."""
        contrib = state.contrib
        lane = state.lane
        if static.env_map_id >= 0 and flat is not None:
            env_missed = (lane & _ENV_MISS_BIT) != 0
            lane = lane & _LANE_MASK
            uv = m.sphere_to_plane(state.d)
            # env-map metadata as compile-time immediates (tex_rows), not a
            # per-lane tex_table row gather
            eoff, ew, eh, efmt = static.tex_rows[static.env_map_id]
            env = bilinear_sample_u32_meta(
                flat.atlas_u32, eoff, ew, eh, bool(efmt), uv
            )
            env_w = 1.0
            if mode == SampleMode.MIS and env_nee:
                # MIS counterweight for BSDF rays escaping to the sky —
                # the env participates in NEE so its hit must be weighted
                from pathtracer.ops.envmap import env_pdf as _env_pdf

                l_eff = jnp.float32(static.num_lights + 1)
                ep = _env_pdf(flat, static, state.d) / l_eff
                env_w = jnp.where(
                    state.prev_pdf > 0.0,
                    m.power_heuristic(state.prev_pdf, ep),
                    1.0,
                )[..., None]
            env_scale = jnp.where(env_missed[..., None], state.color, 0.0)
            contrib = contrib + m.process_nan(env_scale * env * env_w)
        # lanes are permuted by the per-bounce purity sort AND by shrink-
        # boundary compactions; either one requires the lane-keyed
        # un-permute.  (The staged path never shrinks — analytic scenes
        # always run fused — so sort_rays alone still governs it.)
        if sort_rays or shrink_sizes:
            out = jax.lax.sort(
                (lane, contrib[:, 0], contrib[:, 1], contrib[:, 2]),
                num_keys=1,
            )
            return state.img + jnp.stack(out[1:4], axis=1)
        return state.img + contrib

    def bounce_step(flat: FlatScene, key, iteration, state: _BounceState, pixel0=0):
        """Staged-mode body: ONE intersect+shade pass over the pool.

        Identical math to the fused while_loop body, but dispatched from a
        host loop — one jit per bounce, no nested dynamic loops.  Triangle
        scenes on the XLA walk run staged (integrator/render.py).
        Returns (state, alive_count) so the host can early-exit like the
        reference's `num_paths == 0` check (reference: src/pathtrace.cu:790).
        """
        state = bounce_body(flat, key, iteration, pixel0, state)
        return state, jnp.sum(state.alive.astype(jnp.int32))

    if regen:
        render_batch.trace_depth = trace_depth
        render_batch._body = bounce_body  # lap-level debug/profiling hook
        return render_batch
    render_iteration.start_state = start_state
    render_iteration.bounce_step = bounce_step
    render_iteration.finish_state = finish_state
    render_iteration.trace_depth = trace_depth
    return render_iteration
