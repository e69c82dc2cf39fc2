"""Whole-image cross-check: pathtracer vs the independent numpy
oracle (tools/oracle.py).

VERDICT round 2 "Missing #1": every test shares authorship with the code
under test, so the north-star accuracy claim (RMSE < 1e-3 vs the CUDA
reference at 2000 spp, BASELINE.json) was unverifiable against the
reference's stale PNGs (PARITY.md).  This driver renders the SAME scene
with both implementations at matched spp and reports:

  rmse_lin    cross-implementation RMSE of mean linear radiance
  rmse_ldr    cross RMSE after the display transform (ACES+gamma, [0,1])
              — the unit the 1e-3 north star is stated in
  floor_*     each implementation's own seed-to-seed RMSE at the same
              spp (the MC noise floor); the cross RMSE of two unbiased
              renders of the same integral is ~sqrt(floor_a^2+floor_b^2)

A real semantic divergence shows up as rmse >> floor; matched physics
shows rmse ≈ quadrature(floors).

Usage:
  python tools/oracle_compare.py scenes/cornell.txt --mode mis --res 128 --spp 2000

Writes one JSON line to stdout (and optional PNG pairs via --dump).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def _ours_render(scene_path, mode, res, spp, depth, seed, env_is=False):
    """Linear (H, W, 3) mean radiance from pathtracer on CPU.

    `env_is=True` turns on env-map importance sampling (the feature the
    reference left TODO) on OUR side only: both estimators are unbiased
    for the same integral, so the cross-RMSE against the IS-less oracle
    still converges to the quadrature of the two noise floors."""
    from pathtracer.integrator.render import Renderer
    from pathtracer.utils.config import RenderOptions, SampleMode

    modes = {"bsdf": SampleMode.BSDF, "direct": SampleMode.DIRECT_LI,
             "mis": SampleMode.MIS}
    r = Renderer(
        str(scene_path),
        opts=RenderOptions(sample_mode=modes[mode], env_importance=env_is),
        resolution=(res, res),
        trace_depth=depth,
    )
    r.set_seed(seed)
    r.reset()
    step = max(1, min(64, spp))
    done = 0
    while done < spp:
        n = min(step, spp - done)
        r.step(n)
        done += n
    avg = np.asarray(r.img) / max(r.iteration, 1)
    avg = r._unswizzle(avg).reshape(res, res, 3)
    return avg


def _oracle_render(scene_path, mode, res, spp, depth, seed):
    from tools import oracle

    sc = oracle.load_scene(scene_path)
    return oracle.render(
        sc, mode=mode, spp=spp, width=res, height=res, depth=depth, seed=seed
    )


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _ldr(img):
    from tools import oracle

    return oracle.ldr(np.clip(np.nan_to_num(img), 0.0, None))


def compare(scene_path, mode="mis", res=64, spp=64, depth=None, dump=None,
            floors=True, clamp_pct=None, env_is=False, log=lambda *a: None):
    """clamp_pct (e.g. 99.0): clamp BOTH linear images to the given
    percentile of the oracle render before all RMSEs.  Bounds the
    variance of near-delta estimator spikes (tiny sphere lights sampled
    at grazing geometry make the direct-light estimator heavy-tailed:
    single-sample luminance can exceed the mean by 1e4, so the unclamped
    RMSE at any practical spp measures which spikes landed, not physics).
    The clamp is applied identically to both sides, so a systematic
    divergence still shows."""
    scene_path = str(scene_path)
    t0 = time.time()
    ours = _ours_render(scene_path, mode, res, spp, depth, seed=0, env_is=env_is)
    t_ours = time.time() - t0
    log(f"ours: {t_ours:.1f}s")
    t0 = time.time()
    orc = _oracle_render(scene_path, mode, res, spp, depth, seed=0)
    t_orc = time.time() - t0
    log(f"oracle: {t_orc:.1f}s")
    clamp_v = None
    if clamp_pct is not None:
        clamp_v = float(np.percentile(np.asarray(orc), clamp_pct))
        ours = np.minimum(np.asarray(ours), clamp_v)
        orc = np.minimum(np.asarray(orc), clamp_v)

    out = {
        "scene": Path(scene_path).stem,
        "mode": mode,
        "res": res,
        "spp": spp,
        "rmse_lin": _rmse(ours, orc),
        **({"env_is": True} if env_is else {}),
        "rmse_ldr": _rmse(_ldr(ours), _ldr(orc)),
        "secs_ours": round(t_ours, 1),
        "secs_oracle": round(t_orc, 1),
    }
    if clamp_v is not None:
        out["clamp_pct"] = clamp_pct
        out["clamp_value"] = round(clamp_v, 4)
    if floors:
        # each implementation against itself with a different seed at the
        # same spp — the MC noise floor the cross-RMSE is judged against
        ours2 = _ours_render(scene_path, mode, res, spp, depth, seed=1,
                             env_is=env_is)
        orc2 = _oracle_render(scene_path, mode, res, spp, depth, seed=1)
        if clamp_v is not None:
            ours2 = np.minimum(np.asarray(ours2), clamp_v)
            orc2 = np.minimum(np.asarray(orc2), clamp_v)
        out["floor_ours_lin"] = _rmse(ours, ours2)
        out["floor_oracle_lin"] = _rmse(orc, orc2)
        out["floor_ours_ldr"] = _rmse(_ldr(ours), _ldr(ours2))
        out["floor_oracle_ldr"] = _rmse(_ldr(orc), _ldr(orc2))
        out["floor_quad_ldr"] = float(
            np.hypot(out["floor_ours_ldr"], out["floor_oracle_ldr"])
        )
    if dump:
        from pathtracer.utils import image_io

        image_io.write_png(f"{dump}_ours.png", _ldr(ours))
        image_io.write_png(f"{dump}_oracle.png", _ldr(orc))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("--mode", default="mis", choices=["bsdf", "direct", "mis"])
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--dump", default=None, help="PNG path prefix")
    ap.add_argument("--no-floors", action="store_true")
    ap.add_argument("--clamp", type=float, default=None,
                    help="percentile clamp on both linear images")
    ap.add_argument("--env-is", action="store_true",
                    help="env importance sampling ON for ours only")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    out = compare(
        args.scene, args.mode, args.res, args.spp, args.depth,
        dump=args.dump, floors=not args.no_floors, clamp_pct=args.clamp,
        env_is=args.env_is,
        log=lambda *a: print(*a, file=sys.stderr, flush=True),
    )
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
