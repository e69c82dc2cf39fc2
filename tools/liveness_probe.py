"""Per-bounce alive-fraction curve for any scene (CPU, XLA traversal).

Decides where shrink levels pay: a factor-f level saves (1-1/f) of the
per-bounce cost for every bounce it covers, and costs one alive-major
sort at the boundary (scenes that already sort per bounce pay nothing
extra).

Usage: python tools/liveness_probe.py [scene] [res] [mode]
"""
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pathtracer.integrator.wavefront import CameraArrays, make_render_iteration
from pathtracer.scene.camera import derive_camera
from pathtracer.scene.flatscene import build_flat_scene
from pathtracer.scene.parser import load_scene
from pathtracer.utils import rng
from pathtracer.utils.config import RenderOptions, SampleMode

args = sys.argv[1:]
scene_path = args[0] if args else str(Path(__file__).resolve().parents[1] / "scenes" / "cornell.txt")
res = (256, 256)
mode = SampleMode.MIS
for a in args[1:]:
    if "x" in a:
        res = tuple(int(t) for t in a.split("x"))
    else:
        mode = {"mis": SampleMode.MIS, "bsdf": SampleMode.BSDF,
                "direct": SampleMode.DIRECT_LI}[a]

scene = load_scene(scene_path)
scene.camera.resolution = list(res)
flat, static = build_flat_scene(scene)
W, H = scene.camera.resolution
opts = RenderOptions(sample_mode=mode, compaction=False,
                     traversal="xla", pool_shrink=False)
builder = make_render_iteration(static, opts, W, H)
p, v, u, r_, pl_ = derive_camera(scene.camera).as_arrays()
cam = CameraArrays(*[jnp.asarray(x) for x in (p, v, u, r_, pl_)])
key = rng.base_key(0)

n = W * H
state = jax.jit(builder.start_state)(
    flat, cam, jnp.zeros((n, 3), jnp.float32), jnp.int32(1), key
)
step = jax.jit(builder.bounce_step)
print(f"{scene_path} depth={static.trace_depth} pool={n}")
for b in range(static.trace_depth + 1):
    a = int(np.asarray(state.alive).sum())
    print(f"bounce {b}: alive {a}  ({100.0 * a / n:.1f}%)", flush=True)
    if a == 0:
        break
    state, _ = step(flat, key, jnp.int32(1), state)
