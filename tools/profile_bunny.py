"""Profile a scene on the GPU: throughput + the top device ops of a trace.

Usage: python tools/profile_bunny.py [scene] [mis|bsdf|direct]
Writes the trace under chiprun_out/bunny_trace.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

import jax

from pathtracer.utils import jaxcache

jaxcache.enable()

from pathtracer.integrator.render import Renderer
from pathtracer.utils.config import RenderOptions, SampleMode
from pathtracer.utils.profiling import top_ops_from_trace

scene = sys.argv[1] if len(sys.argv) > 1 else "scenes/glassbunny.txt"
mode = {"mis": SampleMode.MIS, "bsdf": SampleMode.BSDF,
        "direct": SampleMode.DIRECT_LI}[sys.argv[2] if len(sys.argv) > 2 else "mis"]
r = Renderer(scene, opts=RenderOptions().with_mode(mode))
print("backend:", jax.default_backend(), "traversal:", r.traversal,
      "staged:", r.staged, "tris:", r.static.num_tris)

r.step(1)  # compile
print(f"compile {r.stats.compile_seconds:.1f}s")
t0 = time.perf_counter()
r.step(3)
dt = time.perf_counter() - t0
print(f"3 iters: {dt:.3f}s  rays={r.stats.rays_traced}  "
      f"{r.stats.rays_traced/dt/1e6:.2f} Mrays/s")

trace_dir = str(Path(__file__).resolve().parents[1] / "chiprun_out" / "bunny_trace")
with jax.profiler.trace(trace_dir):
    r.step(2)
    np.asarray(r.img[0])

for ms, name in top_ops_from_trace(trace_dir, top=25):
    print(f"{ms:10.2f} ms  {name}")
