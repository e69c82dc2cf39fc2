"""Traversal kernel against the XLA walk on the GPU: agreement and time.

    python tools/traversal_ab.py [--phases kernel,render] [--blocks 32,64,128]
                                 [--out chiprun_out/traversal_ab.json]

Phases:
- kernel: one 800x800 pool of glassbunny rays (`ray_pool`: camera rays,
  two thirds of them turned into one bounce off what they hit, half of
  those aimed at the mesh) through the closest-hit and occlusion kernels,
  at each block size, and through the XLA walks.  Reports ms per call
  (median of 5 after a warm-up) and the share of lanes on which the two
  agree.
- render: glassbunny at 800x800, MIS, depth 8 through `Renderer`: the
  kernel (fused path) and the XLA walk (staged path), median ms per pass over 3 windows after 2 warm-up passes; then
  the compile seconds and ms per pass of the fused path with the XLA walk.

Each result is appended to the JSON file as soon as it is measured, with
the card's name and power limit.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

REPO = Path(__file__).resolve().parents[1]
SCENE = REPO / "scenes" / "glassbunny.txt"


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def ray_pool(flat, static, scene, seed: int = 0):
    """(o, d, sd, min_t) for one full-frame pool of the scene's rays.

    A third of the lanes keep their camera ray.  The others leave the point
    their camera ray hit (lanes that hit nothing keep their camera ray):
    a third in a uniformly random direction, a third towards a random point
    of the triangle mesh's bounding box, so that leaf tests, not root-box
    rejects, decide much of the pool.  The shadow segments (sd, min_t) run
    from each origin to a random point of the mesh's box on even lanes and
    of the scene's bounds on odd ones."""
    from pathtracer.integrator.wavefront import CameraArrays, camera_rays
    from pathtracer.ops.traverse import closest_hit
    from pathtracer.scene.camera import derive_camera
    from pathtracer.utils import rng

    w, h = scene.camera.resolution
    n = w * h
    cam = CameraArrays(*(jnp.asarray(a) for a in derive_camera(scene.camera).as_arrays()))
    o, d = camera_rays(cam, w, h, rng.base_key(seed), jnp.int32(1))
    hit = jax.jit(lambda f, o, d: closest_hit(f, static, o, d))(flat, o, d)
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(seed), 4)
    verts = flat.tri_data[:, 0:9].reshape(-1, 3, 3)
    mesh_lo, mesh_hi = verts.min(axis=(0, 1)), verts.max(axis=(0, 1))
    scene_lo = jnp.asarray(static.scene_bounds[0:3], jnp.float32)
    scene_hi = jnp.asarray(static.scene_bounds[3:6], jnp.float32)

    def box_point(key, lo, hi):
        return lo + (hi - lo) * jax.random.uniform(key, (n, 3), jnp.float32)

    lane = jnp.arange(n) % 3
    rnd = jax.random.normal(k1, (n, 3), jnp.float32)
    to_mesh = box_point(k2, mesh_lo, mesh_hi) - hit.point
    nd = jnp.where((lane == 2)[:, None], to_mesh, rnd)
    nd = nd / jnp.linalg.norm(nd, axis=1, keepdims=True)
    bounce = (lane != 0) & (hit.geom >= 0)
    o = jnp.where(bounce[:, None], hit.point + 1e-4 * nd, o)
    d = jnp.where(bounce[:, None], nd, d)
    even = (jnp.arange(n) % 2 == 0)[:, None]
    target = jnp.where(even, box_point(k3, mesh_lo, mesh_hi),
                       box_point(k4, scene_lo, scene_hi))
    sd = target - o
    min_t = jnp.linalg.norm(sd, axis=1)
    return o, d, sd / min_t[:, None], min_t


def _time_ms(fn, *args, reps: int = 5) -> float:
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def agreement(ref_tri, ref_t, tri, t):
    """Share of lanes with equal triangle ids, and the largest relative
    t difference where the ids agree on a hit."""
    ref_tri, tri = np.asarray(ref_tri), np.asarray(tri)
    same = ref_tri == tri
    both = same & (ref_tri >= 0)
    ref_t, t = np.asarray(ref_t)[both], np.asarray(t)[both]
    rel = float(np.max(np.abs(t - ref_t) / np.maximum(np.abs(ref_t), 1e-30))) if both.any() else 0.0
    return float(same.mean()), rel


def kernel_phase(blocks, emit):
    from pathtracer.ops import traverse as tv
    from pathtracer.ops import traverse_kernel as tk
    from pathtracer.scene.flatscene import build_flat_scene
    from pathtracer.scene.parser import load_scene

    scene = load_scene(SCENE)
    flat, static = build_flat_scene(scene)
    o, d, sd, min_t = ray_pool(flat, static, scene)
    n = o.shape[0]
    big = jnp.full((n,), tv.FLT_MAX, jnp.float32)
    none = jnp.full((n,), -1, jnp.int32)
    zero = jnp.zeros((n,), jnp.float32)
    xla_closest = jax.jit(lambda f, o, d: tv._bvh_closest(f, static, o, d, big, none, zero, zero))
    xla_occl = jax.jit(lambda f, o, d, m: tv._bvh_occluded(f, static, o, d, m, jnp.ones((n,), bool)))
    ref_t, ref_tri, _, _ = xla_closest(flat, o, d)
    ref_occ = np.asarray(xla_occl(flat, o, sd, min_t))
    emit({"phase": "kernel", "impl": "xla", "rays": n, "tris": static.num_tris,
          "closest_ms": _time_ms(xla_closest, flat, o, d),
          "occlusion_ms": _time_ms(xla_occl, flat, o, sd, min_t),
          "hit_share": float((np.asarray(ref_tri) >= 0).mean()),
          "occluded_share": float(ref_occ.mean())})
    args = dict(num_nodes=static.num_bvh_nodes, num_trees=static.num_bvh_trees,
                max_prim=static.max_prim)
    for block in blocks:
        closest = jax.jit(lambda f, o, d: tk.closest_hit_kernel(
            f.bvh_f32, f.bvh_i32, f.tri_data, o, d, big, block=block, **args))
        occl = jax.jit(lambda f, o, d, m: tk.occlusion_kernel(
            f.bvh_f32, f.bvh_i32, f.tri_data, o, d, m, block=block, **args))
        t, tri, _, _ = closest(flat, o, d)
        same, rel = agreement(ref_tri, ref_t, tri, t)
        occ_same = float((np.asarray(occl(flat, o, sd, min_t)) == ref_occ).mean())
        emit({"phase": "kernel", "impl": "kernel", "block": block, "rays": n,
              "closest_ms": _time_ms(closest, flat, o, d),
              "occlusion_ms": _time_ms(occl, flat, o, sd, min_t),
              "tri_agree": same, "t_max_rel": rel, "occ_agree": occ_same})


def _render_windows(r, windows: int = 3, passes: int = 4):
    r.step(2)  # compile + warm-up
    per_pass, mrays = [], []
    for _ in range(windows):
        r.stats.wall_seconds, r.stats.rays_traced = 0.0, 0
        s = r.step(passes)
        per_pass.append(s.wall_seconds / passes * 1e3)
        mrays.append(s.mrays_per_sec)
    return statistics.median(per_pass), statistics.median(mrays), per_pass


def render_phase(emit):
    from pathtracer.integrator.render import Renderer
    from pathtracer.integrator.wavefront import make_render_iteration
    from pathtracer.utils.config import RenderOptions, SampleMode

    base = RenderOptions(sample_mode=SampleMode.MIS)
    for name, opts in (("kernel", base),
                       ("xla_staged", replace(base, traversal="xla"))):
        r = Renderer(SCENE, opts=opts)
        ms, mrays, windows = _render_windows(r)
        emit({"phase": "render", "impl": name, "staged": r.staged,
              "compile_s": r.stats.compile_seconds, "ms_per_pass": ms,
              "mrays_per_sec": mrays, "windows_ms": windows})
        del r
    # the fused path with the XLA walk nested in the bounce loop
    r = Renderer(SCENE, opts=replace(base, traversal="xla"))
    order = r.pixel_order
    pixel_xy = (jnp.asarray((order % r.width).astype(np.float32)),
                jnp.asarray((order // r.width).astype(np.float32)))
    fused = jax.jit(make_render_iteration(r.static, r.opts, r.width, r.height,
                                          pixel_xy=pixel_xy))
    cam = r._cam_arrays()
    t0 = time.perf_counter()
    compiled = fused.lower(r.flat, cam, r.img, jnp.int32(1), r.key).compile()
    compile_s = time.perf_counter() - t0
    img = r.img
    jax.block_until_ready(compiled(r.flat, cam, img, jnp.int32(1), r.key))
    t0 = time.perf_counter()
    for it in range(4):
        img, _, _ = compiled(r.flat, cam, img, jnp.int32(it + 2), r.key)
    jax.block_until_ready(img)
    emit({"phase": "render", "impl": "xla_fused", "compile_s": compile_s,
          "ms_per_pass": (time.perf_counter() - t0) / 4 * 1e3})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="kernel,render")
    ap.add_argument("--blocks", default="32,64,128")
    ap.add_argument("--out", type=Path, default=REPO / "chiprun_out" / "traversal_ab.json")
    args = ap.parse_args(argv)
    if jax.default_backend() != "gpu":
        print(f"needs a GPU; JAX found {jax.default_backend()}", file=sys.stderr)
        return 1
    from pathtracer.scene.assets import ensure_assets
    from pathtracer.utils import jaxcache

    ensure_assets()
    jaxcache.enable()
    dev = jax.devices()[0]
    meta = {"card": card(), "device_kind": dev.device_kind}
    print(json.dumps(meta), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    results = []

    def emit(row):
        row = {**meta, **row}
        results.append(row)
        print(json.dumps(row), flush=True)
        args.out.write_text(json.dumps(results, indent=1))

    phases = args.phases.split(",")
    if "kernel" in phases:
        kernel_phase([int(b) for b in args.blocks.split(",")], emit)
    if "render" in phases:
        render_phase(emit)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
