"""pathtracer — a wavefront path tracer in JAX for the GPU.

A from-scratch rebuild of the capabilities of the CUDA path tracer
`zhiyi1801/Project3-CUDA-Path-Tracer-1`:

- fixed-shape SoA ray pools in device memory instead of pointer-soup
  device structs
- jit-compiled wavefront stages composed in `lax.while_loop` (no host
  round-trips per bounce, unlike the reference's `compact_rays` D2H copies,
  reference: src/pathtrace.cu:614-631)
- stackless threaded-MTBVH traversal per ray, as a Pallas kernel on the
  GPU and a batched `lax.while_loop` on the CPU, over one flattened node
  table (reference: src/BVH.cpp:149-239, src/pathtrace.cu:236-279)
- counter-based threefry RNG keyed on (iteration, bounce, stage) for
  bitwise-reproducible renders (the reference hash-seeds thrust engines,
  src/pathtrace.cu:25-29)
- multi-device scaling via `jax.sharding.Mesh` + `shard_map` over the
  pixel space (the reference is single-GPU only)

Layer map (mirrors SURVEY.md §1):
  scene/       L1  scene text format parser, OBJ loader, textures, camera
  accel/       L2  SAH BVH build + stackless flatten + 6-way MTBVH
  ops/         L3  device math/sampling/BSDF/intersection/traversal kernels
  integrator/  L4  wavefront render loop (BSDF / direct-light / MIS modes)
  parallel/    L5' device-mesh sharding (replaces CUDA-GL interop layer)
  preview/     L6  headless progressive preview (replaces OpenGL/ImGui UI)
  utils/       L0  RNG, image IO, profiling, config
"""

__version__ = "0.1.0"

from pathtracer.utils.config import RenderOptions, SampleMode  # noqa: F401
