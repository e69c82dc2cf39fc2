"""Render a scene deterministically and dump the raw image sum to .npy.

Used for old-vs-new bit-identity A/B across checkouts (run once with
PYTHONPATH at each checkout, then np.array_equal the dumps).

Usage: python tools/ab_render_dump.py <scene> <mode> <iters> <out.npy> [cpu]
"""
import sys

import numpy as np

scene, mode_s, iters, out = sys.argv[1:5]
if len(sys.argv) > 5 and sys.argv[5] == "cpu":
    import jax

    jax.config.update("jax_platforms", "cpu")

from pathtracer.utils import jaxcache

jaxcache.enable()

from pathtracer.integrator.render import Renderer
from pathtracer.utils.config import RenderOptions, SampleMode

mode = {"mis": SampleMode.MIS, "bsdf": SampleMode.BSDF,
        "direct": SampleMode.DIRECT_LI}[mode_s]
res = None
if len(sys.argv) > 6:
    w, h = sys.argv[6].split("x")
    res = (int(w), int(h))
r = Renderer(scene, opts=RenderOptions(sample_mode=mode), resolution=res)
r.step(int(iters))
np.save(out, np.asarray(r.img))
print("saved", out, "mean", float(np.asarray(r.img).mean()))
