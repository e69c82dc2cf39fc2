"""Render configuration.

The reference scatters its configuration over three layers (SURVEY.md §5):
compile-time #defines (reference: src/utilities.h:22-29, src/BVH.h:5-6),
the scene file's CAMERA block, and runtime UI state (the SampleMode combo,
reference: src/preview.cpp:245-252).  Here all of it is one frozen dataclass
(hashable, so it can be a static jit argument) plus the per-scene RenderState
carried by the parsed scene.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace


class SampleMode(enum.IntEnum):
    """Integrator mode (reference: src/preview.h enum SampleMode)."""

    BSDF = 0       # BSDF importance sampling only   (PTkernel)
    DIRECT_LI = 1  # next-event estimation only      (DirectLiPTkernel)
    MIS = 2        # NEE + BSDF with power heuristic (MisPTkernel)


@dataclass(frozen=True)
class RenderOptions:
    """Feature switches, mirroring the reference's compile-time flags.

    reference: src/utilities.h:22-29 (USE_BVH/USE_SAH/USE_MTBVH/TONEMAPPING/
    VERTEX_NORMAL/SHOW_NORMAL/ROUGHNESS_MIN/ROUGHNESS_MAX) and
    src/BVH.h:5-6 (MAX_PRIM/BUCKET_NUM).
    """

    use_bvh: bool = True       # False = brute-force triangle sweep
    use_sah: bool = True       # False = median-split build
    use_mtbvh: bool = True     # False = single-tree threaded layout
    tonemapping: bool = True
    vertex_normal: bool = True  # False = face normals even when OBJ has them
    show_normal: bool = False   # first-hit normal debug view
    max_prim: int = 1          # BVH leaf capacity (reference: src/BVH.h:5)
    bucket_num: int = 20       # SAH buckets (reference: src/BVH.h:6)
    # ROUGHNESS_MIN/MAX stay compile-time constants (the reference's
    # src/utilities.h:28-29), applied at parse (scene/parser.py:48) and at
    # sample time (ops/materials.py:49) — not runtime options.

    # additions with no reference counterpart
    sample_mode: SampleMode = SampleMode.BSDF
    env_importance: bool = False  # env-map CDF importance sampling; the
    # reference builds the luminance CDF but never samples it
    # (reference: src/scene.cpp:514-529, README.md:25-27 TODO)
    traversal: str = "auto"       # triangle BVH walk: "auto" = the per-ray
    # kernel on the GPU, the XLA walk elsewhere; "xla" forces the XLA walk.
    # See ops/traverse.resolve_traversal.
    compaction: bool = True       # per-bounce ray sorting by (alive, octant,
    # origin cell), the counterpart of the reference's compact_rays
    # (reference: src/pathtrace.cu:614-631), with the count kept on device.
    # One multi-operand lax.sort over 1D columns; the image scatter-add
    # happens once per ITERATION (contrib rides the ray).
    pool_shrink: bool = True      # straggler-phase pool compaction: once
    # <25% of lanes are alive, the live rays are sorted to the front and
    # the remaining bounces run in a statically-shaped quarter pool.
    # Lane-keyed RNG + ride-the-ray accumulation make it bit-identical to
    # the full-pool render (tests enforce).
    shrink_levels: int = 2        # pool_shrink depth: each level quarters
    # the pool (640k -> 160k -> 40k -> ...); each level adds a compiled
    # while body + sort
    shrink_half: bool = False     # insert a pool/2 level at the FRONT of
    # the shrink ladder (fires once alive <= 50%), for scenes whose
    # liveness lingers in the 25-50% band for several tail bounces.  Each
    # boundary is a full multi-operand sort, so analytic scenes, which
    # never sort otherwise, should not set it.
    sort_every: int = 1           # re-sort the pool every k-th bounce only
    # (depth 0 always sorts); output is bit-identical for any k (RNG keys
    # on lane, contributions ride the ray, the image scatter is
    # collision-free)
    swizzle: bool = True          # order the ray pool in 32x32 pixel blocks
    # so neighbouring lanes trace neighbouring pixels (single-device path)
    ray_regen: int = 0            # cross-iteration ray regeneration: > 1
    # renders k samples/pixel in ONE persistent pool — a lane whose path
    # dies is refilled in place with the camera ray for its pixel's next
    # sample index, so per-bounce fixed costs (launches, the multi-operand
    # sort, material/atlas/env taps) amortize over a near-full-live pool
    # instead of the liveness tails.  Physics exact (same (pixel, sample,
    # bounce, stage) RNG streams; only float-add order changes — which is
    # why it stays OPT-IN: the classic path keeps the bitwise
    # checkpoint-resume invariant, regen's batch splits do not).
    # bench.py/CLI enable it per scene; its per-scene value is still to be
    # measured on the GPU (ROADMAP S10).  Applies to the fused BSDF/MIS
    # single-device path; DIRECT_LI / staged / sharded ignore it.
    iters_per_dispatch: int = 0   # batch k iterations into one jit call
    # (k sequential bounce loops, not nested) to amortize per-dispatch
    # latency.  0 = auto: 8 for analytic scenes, 2 for triangle scenes; the
    # choice is still to be measured on the GPU (ROADMAP S10).
    # Bit-identical to unbatched: RNG keys on (iteration, lane).

    def with_mode(self, mode: SampleMode) -> "RenderOptions":
        return replace(self, sample_mode=SampleMode(mode))


# Shared numeric constants (reference: src/utilities.h:13-20)
PI = 3.1415926535897932384626422832795028841971
TWO_PI = 2.0 * PI
INV_PI = 1.0 / PI
EPSILON = 1e-4
RAY_BIAS = 1e-3
BACKGROUND_COLOR = (0.0, 0.0, 0.0)
