#!/usr/bin/env python3
"""Proof that the path tracer runs on a GPU, end to end, at full size.

    python chip_smoke.py           # one GPU: phases 1-3
    python chip_smoke.py --four    # four GPUs: phase 1 and the sharded phase

Phases, in order; the script exits non-zero at the first failure:

1. Device: JAX's backend must be the GPU (JAX falls back to the CPU when its
   CUDA plugin does not load).  Prints the card's name and power limit.
2. Main path, through `Renderer`: glassbunny (the seeded ~15.7k-triangle
   glass mesh) at 800x800, MIS, depth 8: 2 warm-up passes, then 8.  Checks
   the mesh is there, the traversal kernel is the walk in use, rays were
   traced and the image is finite and not black.  Then cornell (MIS, with
   the ray regeneration bench.py uses) and textureenv (an albedo texture
   under an HDR sky, env importance sampling on), briefly.
3. The traversal kernel against the XLA walk on one 640k-ray glassbunny
   pool, and a 64x64 glassbunny render on the GPU against the same render
   on the CPU backend in this process.
4. `--four` only: glassbunny at 800x800 pixel-sharded over 4 GPUs against
   the 1-GPU render of the same passes, and one sample-space step.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

SCENES = HERE / "scenes"

# Phase 3 tolerances.  The kernel and the XLA walk run the same float32
# arithmetic in a different order (and the GPU contracts multiply-adds), so
# a ray that grazes a shared edge or vertex can pick either neighbour:
# triangle ids must agree on >= 99.99% of lanes, and on >= 99.9% of the
# lanes where either walk hits a triangle.  Where the ids agree the
# hit distances must agree to 1e-5 relative on >= 99.99% of those lanes;
# grazing hits, where the determinant is tiny, are the allowed remainder.
# Occlusion answers must agree on >= 99.99% of lanes.
MIN_TRI_AGREE = 0.9999
MIN_HIT_AGREE = 0.999
T_REL_TOL = 1e-5
MIN_OCC_AGREE = 0.9999
# The pool must exercise the leaves: a fifth of its lanes must hit a
# triangle (ray_pool aims a third of them at the mesh).
MIN_TRI_HIT_SHARE = 0.2
# GPU against CPU image (64x64, 4 spp, same seed).  The two backends
# compute transcendental functions (sin, cos, exp, pow, sqrt) to within a
# few ulp of each other but not bit for bit, so a path whose next event
# sits on a decision boundary (a Fresnel choice against a random number, a
# ray grazing an edge) can branch differently and change its pixel by up
# to a sample's share (1/4).  Such pixels must be few: at most 5% of the
# pixels may differ by more than 2/255 in the tonemapped image, and the
# mean absolute difference must stay under 0.01.
MAX_DIFF_PIXEL_SHARE = 0.05
PIXEL_TOL = 2.0 / 255.0
MAX_MEAN_ABS_DIFF = 0.01
# Phase 4 tolerances.  The sharded and the 1-card render run the same
# per-pixel arithmetic on the same random numbers (the RNG is keyed by
# pixel and iteration); the sample-space step runs the same iterations and
# sums them in another order, which moves a sum by an ulp or two.  XLA may
# also fuse the two programs' shapes differently, and a multiply-add
# contracted in one and not the other moves a value by an ulp; a path whose
# next choice sits within that ulp of its threshold then branches
# differently; on a glass mesh, where a grazed edge or a Fresnel choice
# decides each refraction, such paths are few but not none (2.08e-4 of the
# pixels on 4x H100 at 800x800, 2 passes).  So a pixel agrees when each
# channel of its radiance sum is within 1e-5 of the 1-card one, relative to
# 1 + |value|; at most 1e-3 of the pixels may disagree, and they must be
# scattered: at most 5% of any one image row.  A shard-boundary fault
# shows as whole rows (one wrong row per shard is 5e-3 of the pixels and
# 100% of its row).
SHARD_RAD_TOL = 1e-5
MAX_SHARD_DIFF_SHARE = 1e-3
MAX_SHARD_ROW_SHARE = 0.05


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def phase_device():
    import jax

    backend = jax.default_backend()
    check(backend == "gpu", f"JAX backend is {backend!r}, not 'gpu'")
    devs = jax.devices()
    print(f"card: {card()}", flush=True)
    print(f"jax: {devs[0].platform} {devs[0].device_kind} x{len(devs)}", flush=True)
    return devs


def render(scene, opts, warm: int, passes: int, **kw):
    """Renderer through its normal entry point: `warm` passes (the first
    compiles), then `passes` timed ones.  Returns (renderer, timing)."""
    from pathtracer.integrator.render import Renderer

    r = Renderer(str(scene), opts=opts, **kw)
    r.step(warm)
    r.stats.wall_seconds, r.stats.rays_traced = 0.0, 0
    stats = r.step(passes)
    return r, {
        "compile_s": stats.compile_seconds,
        "ms_per_pass": stats.wall_seconds / passes * 1e3,
        "mrays": stats.mrays_per_sec,
        "rays": stats.rays_traced,
    }


def check_image(r, name: str):
    import numpy as np

    img = np.asarray(r.img)
    check(np.isfinite(img).all(), f"{name}: non-finite radiance")
    ldr = r.ldr_image()
    check(ldr.mean() > 0.01, f"{name}: black image (mean {ldr.mean():.4g})")
    return ldr


def report(name, r, timing, smi):
    print(
        f"{name}: {r.width}x{r.height} depth {r.static.trace_depth} "
        f"tris {r.static.num_tris} traversal {r.traversal} "
        f"{'staged' if r.staged else 'fused'} | compile {timing['compile_s']:.1f} s | "
        f"{timing['ms_per_pass']:.2f} ms/pass | {timing['mrays']:.2f} Mrays/s | {smi}",
        flush=True,
    )


def phase_main(smi, size=(800, 800), depth=8, passes=8):
    from pathtracer.utils.config import RenderOptions, SampleMode

    mis = RenderOptions(sample_mode=SampleMode.MIS)
    r, stats = render(SCENES / "glassbunny.txt", mis, warm=2, passes=passes,
                      resolution=size, trace_depth=depth)
    check(r.static.num_tris >= 10_000, f"glassbunny has {r.static.num_tris} triangles")
    check(r.traversal == "kernel" and not r.staged,
          f"glassbunny took traversal {r.traversal!r} (staged={r.staged})")
    check(stats["rays"] > 0, "glassbunny traced no rays")
    check_image(r, "glassbunny")
    report("glassbunny", r, stats, smi)
    del r

    r, stats = render(SCENES / "cornell.txt", replace(mis, ray_regen=16),
                      warm=2, passes=passes, resolution=size, trace_depth=depth)
    check(stats["rays"] > 0, "cornell traced no rays")
    import numpy as np

    check(np.isfinite(np.asarray(r.img)).all(), "cornell: non-finite radiance")
    check(float(np.asarray(r.img).max()) > 0, "cornell: black image")
    report("cornell", r, stats, smi)
    del r

    # one iteration per dispatch here and in phase 3: one compile, not two
    r, stats = render(SCENES / "textureenv.txt",
                      replace(mis, env_importance=True, iters_per_dispatch=1),
                      warm=1, passes=4, resolution=size, trace_depth=depth)
    check(r.static.has_textures and r.static.env_map_id >= 0,
          "textureenv lost its texture or its environment")
    check(r.traversal == "kernel", f"textureenv took traversal {r.traversal!r}")
    check(stats["rays"] > 0, "textureenv traced no rays")
    check_image(r, "textureenv")
    report("textureenv", r, stats, smi)


def phase_kernel(smi, size=(800, 800), image_size=(64, 64)):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pathtracer.ops import traverse as tv
    from pathtracer.ops import traverse_kernel as tk
    from pathtracer.scene.flatscene import build_flat_scene
    from pathtracer.scene.parser import load_scene
    from pathtracer.utils.config import RenderOptions, SampleMode
    from tools.traversal_ab import ray_pool

    scene = load_scene(SCENES / "glassbunny.txt")
    scene.camera.resolution = size
    flat, static = build_flat_scene(scene)
    o, d, sd, min_t = ray_pool(flat, static, scene)
    n = o.shape[0]
    big = jnp.full((n,), tv.FLT_MAX, jnp.float32)
    none = jnp.full((n,), -1, jnp.int32)
    zero = jnp.zeros((n,), jnp.float32)
    ref_t, ref_tri, _, _ = jax.jit(
        lambda f, o, d, big, none, zero: tv._bvh_closest(f, static, o, d, big, none, zero, zero)
    )(flat, o, d, big, none, zero)
    ref_occ = jax.jit(
        lambda f, o, d, m: tv._bvh_occluded(f, static, o, d, m, jnp.ones(m.shape, bool))
    )(flat, o, sd, min_t)
    kargs = dict(num_nodes=static.num_bvh_nodes, num_trees=static.num_bvh_trees,
                 max_prim=static.max_prim)
    t, tri, _, _ = jax.jit(lambda f, o, d, t0: tk.closest_hit_kernel(
        f.bvh_f32, f.bvh_i32, f.tri_data, o, d, t0, **kargs))(flat, o, d, big)
    occ = jax.jit(lambda f, o, d, m: tk.occlusion_kernel(
        f.bvh_f32, f.bvh_i32, f.tri_data, o, d, m, **kargs))(flat, o, sd, min_t)
    ref_tri, tri = np.asarray(ref_tri), np.asarray(tri)
    same = ref_tri == tri
    both = same & (ref_tri >= 0)
    either = (ref_tri >= 0) | (tri >= 0)
    hit_agree = float(same[either].mean()) if either.any() else 0.0
    rel = np.abs(np.asarray(t)[both] - np.asarray(ref_t)[both]) / np.asarray(ref_t)[both]
    t_ok = float((rel <= T_REL_TOL).mean()) if both.any() else 1.0
    occ_agree = float((np.asarray(occ) == np.asarray(ref_occ)).mean())
    print(
        f"kernel vs XLA walk, {n} rays, {static.num_tris} tris, {either.mean():.3f} "
        f"of lanes hit a triangle (>= {MIN_TRI_HIT_SHARE}): tri ids agree "
        f"{same.mean():.6f} (>= {MIN_TRI_AGREE}), on {either.sum()} hit lanes "
        f"{hit_agree:.6f} (>= {MIN_HIT_AGREE}), t within "
        f"{T_REL_TOL:g} rel on {t_ok:.6f} (>= {MIN_TRI_AGREE}), max rel "
        f"{rel.max() if both.any() else 0:.3g}; occlusion agrees {occ_agree:.6f} "
        f"(>= {MIN_OCC_AGREE}), occluded {np.asarray(ref_occ).mean():.3f} | {smi}",
        flush=True,
    )
    check(either.mean() >= MIN_TRI_HIT_SHARE,
          f"only {either.mean():.3f} of the pool's lanes hit a triangle")
    check(same.mean() >= MIN_TRI_AGREE, "kernel and XLA walk disagree on triangle ids")
    check(hit_agree >= MIN_HIT_AGREE, "kernel and XLA walk disagree on hit lanes")
    check(t_ok >= MIN_TRI_AGREE, "kernel and XLA walk disagree on hit distances")
    check(occ_agree >= MIN_OCC_AGREE, "kernel and XLA walk disagree on occlusion")

    # the same small render on the GPU (kernel) and on the CPU (XLA walk)
    mis = RenderOptions(sample_mode=SampleMode.MIS, iters_per_dispatch=1)
    r_gpu, _ = render(SCENES / "glassbunny.txt", mis, warm=1, passes=3,
                      resolution=image_size, trace_depth=8)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        r_cpu, _ = render(SCENES / "glassbunny.txt", replace(mis, traversal="xla"),
                          warm=1, passes=3, resolution=image_size, trace_depth=8)
    a, b = r_gpu.ldr_image(), r_cpu.ldr_image()
    diff = np.abs(a - b).max(axis=-1)
    share = float((diff > PIXEL_TOL).mean())
    print(
        f"GPU ({r_gpu.traversal}) vs CPU ({r_cpu.traversal}) glassbunny "
        f"{image_size[0]}x{image_size[1]} 4 spp: {share:.4f} of pixels differ by "
        f"> {PIXEL_TOL:.4f} (<= {MAX_DIFF_PIXEL_SHARE}), mean abs diff "
        f"{np.abs(a - b).mean():.5f} (<= {MAX_MEAN_ABS_DIFF}), max {diff.max():.3f}",
        flush=True,
    )
    check(share <= MAX_DIFF_PIXEL_SHARE, "GPU and CPU images differ in too many pixels")
    check(float(np.abs(a - b).mean()) <= MAX_MEAN_ABS_DIFF, "GPU and CPU images differ")


def disagreement(a, b, width: int):
    """Pixels whose radiance differs beyond SHARD_RAD_TOL (of 1 + |b|) in
    some channel: their share of the image and of its worst row, and the
    largest absolute difference."""
    import numpy as np

    diff = np.abs(a - b)
    bad = (diff > SHARD_RAD_TOL * (1.0 + np.abs(b))).any(axis=-1)
    return (float(bad.mean()), float(bad.reshape(-1, width).mean(axis=1).max()),
            float(diff.max()))


def check_agreement(what: str, a, b, width: int) -> str:
    import numpy as np

    share, row, max_diff = disagreement(a, b, width)
    msg = (f"radiance bitwise equal {bool(np.array_equal(a, b))}, {share:.6f} of "
           f"pixels differ by > {SHARD_RAD_TOL:g} rel (<= {MAX_SHARD_DIFF_SHARE:g}), "
           f"worst row {row:.4f} (<= {MAX_SHARD_ROW_SHARE}), max abs diff {max_diff:.3g}")
    check(share <= MAX_SHARD_DIFF_SHARE and row <= MAX_SHARD_ROW_SHARE,
          f"{what} differ: {msg}")
    return msg


def compile_together(*lowered):
    """Compile lowered programs at once, one thread each (XLA compiles
    without the GIL); later calls of the same jitted functions reuse them."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(lowered)) as pool:
        return list(pool.map(lambda low: low.compile(), lowered))


def phase_four(smi, size=(800, 800), passes=2, devices=4):
    """Pixel-space sharding over `devices` cards against one card, then
    one sample-space step against the same iterations on one card.

    The 1-card render runs without the 32x32 pixel swizzle: the swizzled
    pool keys its random numbers by lane, so it draws other samples than
    the pixel-ordered sharded pool (equal in distribution, not sample for
    sample).  Without it both key by pixel and agree to SHARD_RAD_TOL.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pathtracer.integrator.render import Renderer
    from pathtracer.parallel import sharding as sh
    from pathtracer.utils.config import RenderOptions, SampleMode

    check(len(jax.devices()) >= devices, f"{len(jax.devices())} devices, need {devices}")
    mis = RenderOptions(sample_mode=SampleMode.MIS)
    scene = str(SCENES / "glassbunny.txt")
    r1 = Renderer(scene, opts=replace(mis, swizzle=False, iters_per_dispatch=1),
                  resolution=size, trace_depth=8)
    rs = Renderer(scene, opts=mis, resolution=size, trace_depth=8, devices=devices)
    check(rs.traversal == "kernel", f"sharded render took {rs.traversal!r}")
    sample_step, combine = sh.sample_parallel_step(r1.static, mis, size[0], size[1], rs.mesh)
    stacked = jax.device_put(
        jnp.zeros((devices * size[0] * size[1], 3), jnp.float32),
        jax.sharding.NamedSharding(rs.mesh, jax.sharding.PartitionSpec(sh.AXIS)),
    )
    cam, it = r1._cam_arrays(), jnp.int32(1)
    t0 = time.perf_counter()
    compile_together(
        r1._iter_fn.lower(r1.flat, cam, r1.img, it, r1.key),
        rs._sharded_step.lower(rs.flat, cam, rs.img, it, rs.key),
        sample_step.lower(r1.flat, cam, stacked, it, r1.key),
    )
    compile_s = time.perf_counter() - t0
    rs.step(passes)
    r1.step(passes)
    a = rs._unswizzle(np.asarray(rs.img)).reshape(-1, 3)
    b = np.asarray(r1.img)
    print(f"pixel-sharded x{devices} vs 1 card, glassbunny {size[0]}x{size[1]} "
          f"{passes} passes; the three programs compiled together in "
          f"{compile_s:.1f} s | {smi}", flush=True)
    print("pixel-sharded: " + check_agreement(
        "sharded and 1-card renders", a, b, size[0]), flush=True)

    # sample space: device k renders iteration k+1 of the full frame; the
    # sum is the 1-card accumulator after `devices` iterations
    r1.step(devices - passes)
    stacked, rays = sample_step(r1.flat, cam, stacked, it, r1.key)
    combined = np.asarray(combine(stacked))
    want = np.asarray(r1.img)
    check(int(rays) > 0, "sample-space step traced no rays")
    check(np.isfinite(combined).all(), "sample-space image not finite")
    print(f"sample-space x{devices}: {int(rays)} rays; combined image vs "
          f"{devices} sequential 1-card iterations: " + check_agreement(
              "sample-space and sequential images", combined, want, size[0]),
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the 4-GPU sharded phase (and the device phase) only")
    args = ap.parse_args(argv)
    try:
        from pathtracer.scene.assets import ensure_assets

        from pathtracer.utils import jaxcache

        devs = phase_device()
        smi = card()
        ensure_assets()
        jaxcache.enable()
        if args.four:
            phase_four(smi)
        else:
            phase_main(smi)
            phase_kernel(smi)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
