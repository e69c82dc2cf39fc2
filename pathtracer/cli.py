"""Command-line interface.

Replaces the reference's single-positional-arg main + GLFW window
(reference: src/main.cpp:78-96) with a headless CLI:

    python -m pathtracer.cli render <scene.txt> [options]
    python -m pathtracer.cli info   <scene.txt>
    python -m pathtracer.cli bench  <scene.txt> [options]

The scene file carries resolution/spp/depth/output-name exactly as the
reference's CAMERA block does; flags override.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("scene", help="scene .txt file (reference format)")
    p.add_argument(
        "--mode",
        choices=["bsdf", "direct", "mis"],
        default="bsdf",
        help="integrator (SampleMode combo of the reference UI)",
    )
    p.add_argument("--spp", type=int, default=None, help="iterations (default: scene ITERATIONS)")
    p.add_argument("--depth", type=int, default=None, help="max bounces (default: scene DEPTH)")
    p.add_argument("--res", type=str, default=None, help="WxH override, e.g. 800x800")
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    p.add_argument("--no-tonemap", action="store_true", help="skip ACES+gamma on save")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--devices", type=int, default=None,
        help="shard pixel rows over N devices (jax.sharding.Mesh); the "
        "pixel-keyed RNG draws the samples of a 1-device render without "
        "the pixel swizzle",
    )
    p.add_argument(
        "--regen", type=int, default=0, metavar="K",
        help="cross-iteration ray regeneration: render K samples/pixel "
        "per persistent-pool dispatch, refilling dead lanes with "
        "next-sample camera rays (same sample set; float-add order "
        "within a pixel changes)",
    )


def _parse_mode(s: str):
    from pathtracer.utils.config import SampleMode

    return {"bsdf": SampleMode.BSDF, "direct": SampleMode.DIRECT_LI, "mis": SampleMode.MIS}[s]


def _parse_res(s):
    if s is None:
        return None
    try:
        w, h = s.lower().split("x")
        return (int(w), int(h))
    except ValueError:
        raise SystemExit(f"error: --res expects WxH (e.g. 800x800), got {s!r}")


def _print_devices():
    """Device report at startup (reference: src/main.cpp:50-73 prints CUDA
    device properties)."""
    import jax

    for d in jax.devices():
        print(f"device: {d.device_kind} ({d.platform}) id={d.id}", file=sys.stderr)


def cmd_render(args) -> int:
    from pathtracer.integrator.render import Renderer
    from pathtracer.utils.config import RenderOptions

    _print_devices()

    opts = RenderOptions(
        sample_mode=_parse_mode(args.mode), tonemapping=not args.no_tonemap,
        ray_regen=max(args.regen, 0),
    )
    r = Renderer(
        args.scene,
        opts=opts,
        resolution=_parse_res(args.res),
        trace_depth=args.depth,
        devices=args.devices,
    )
    r.set_seed(args.seed)
    if args.resume and Path(args.resume).exists():
        r.load_checkpoint(args.resume)
        print(f"resumed from {args.resume} at iteration {r.iteration}")
    total = args.spp if args.spp is not None else r.static.iterations
    out = Path(args.out) if args.out else Path(f"{r.static.image_name}.png")

    chunk = max(1, min(args.save_every or total, total))
    done = r.iteration
    t0 = time.perf_counter()
    while done < total:
        n = min(chunk, total - done)
        stats = r.step(n)
        done = r.iteration
        elapsed = time.perf_counter() - t0
        print(
            f"[{done}/{total}] {stats.mrays_per_sec:8.2f} Mrays/s  "
            f"{elapsed:7.1f}s elapsed",
            flush=True,
        )
        if args.save_every:
            r.save_png(out)
            if args.checkpoint:
                r.save_checkpoint(args.checkpoint)
    r.save_png(out)
    if args.hdr:
        r.save_hdr(out.with_suffix(".hdr"))
    if args.checkpoint:
        r.save_checkpoint(args.checkpoint)
    print(f"saved {out} ({r.iteration} spp)")
    return 0


def cmd_info(args) -> int:
    from pathtracer.scene.flatscene import build_flat_scene
    from pathtracer.scene.parser import load_scene

    scene = load_scene(args.scene)
    flat, static = build_flat_scene(scene)
    info = {
        "scene": str(scene.path),
        "resolution": list(scene.camera.resolution),
        "iterations": static.iterations,
        "trace_depth": static.trace_depth,
        "geoms": static.num_geoms,
        "triangles": static.num_tris,
        "bvh_nodes": static.num_bvh_nodes,
        "bvh_trees": static.num_bvh_trees,
        "materials": static.num_materials,
        "lights": static.num_lights,
        "textures": len(scene.textures),
        "env_map": static.env_map_id >= 0,
        "image_name": static.image_name,
    }
    print(json.dumps(info, indent=2))
    return 0


def cmd_bench(args) -> int:
    from pathtracer.integrator.render import Renderer
    from pathtracer.utils.config import RenderOptions

    opts = RenderOptions(
        sample_mode=_parse_mode(args.mode), ray_regen=max(args.regen, 0)
    )
    r = Renderer(
        args.scene, opts=opts, resolution=_parse_res(args.res),
        trace_depth=args.depth, devices=args.devices,
    )
    warm = r.step(1)  # compile + warmup
    r.stats.wall_seconds = 0.0
    r.stats.rays_traced = 0
    spp = args.spp or 32
    stats = r.step(spp)
    import jax

    dev = jax.devices()[0]
    result = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "scene": Path(args.scene).stem,
        "mode": args.mode,
        "resolution": [r.width, r.height],
        "spp": spp,
        "compile_seconds": round(warm.compile_seconds, 3),
        "wall_seconds": round(stats.wall_seconds, 4),
        "rays_traced": stats.rays_traced,
        "mrays_per_sec": round(stats.mrays_per_sec, 3),
    }
    print(json.dumps(result))
    return 0


def cmd_preview(args) -> int:
    from pathtracer.integrator.render import Renderer
    from pathtracer.preview.server import run_preview
    from pathtracer.utils.config import RenderOptions

    opts = RenderOptions(sample_mode=_parse_mode(args.mode))
    r = Renderer(
        args.scene, opts=opts, resolution=_parse_res(args.res), trace_depth=args.depth
    )
    run_preview(r, host=args.host, port=args.port, chunk=args.chunk,
                max_iterations=args.spp)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="pathtracer", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene to PNG")
    _add_common(pr)
    pr.add_argument("-o", "--out", default=None, help="output PNG path")
    pr.add_argument("--hdr", action="store_true", help="also write Radiance .hdr")
    pr.add_argument("--save-every", type=int, default=None, help="progressive save interval (spp)")
    pr.add_argument("--checkpoint", default=None, help="checkpoint .npz path to write")
    pr.add_argument("--resume", default=None, help="checkpoint .npz to resume from")
    pr.set_defaults(fn=cmd_render)

    pi = sub.add_parser("info", help="print scene statistics as JSON")
    pi.add_argument("scene")
    pi.set_defaults(fn=cmd_info)

    pb = sub.add_parser("bench", help="measure Mrays/s")
    _add_common(pb)
    pb.set_defaults(fn=cmd_bench)

    pv = sub.add_parser("preview", help="interactive web preview (orbit camera)")
    _add_common(pv)
    pv.add_argument("--port", type=int, default=8000)
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--chunk", type=int, default=4, help="spp per display update")
    pv.set_defaults(fn=cmd_preview)

    args = parser.parse_args(argv)
    if getattr(args, "cpu", False):
        import jax

        jax.config.update("jax_platforms", "cpu")
    try:
        return args.fn(args)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
