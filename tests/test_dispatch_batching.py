"""Iteration batching (RenderOptions.iters_per_dispatch).

Batching folds k progressive iterations into one jit dispatch (k
sequential bounce loops) to amortize per-dispatch latency; it must be
BIT-identical to the one-at-a-time path because the
RNG keys on (iteration, lane) and accumulation is associative-free
(pure adds of the same values in the same order).
"""

from dataclasses import replace
from pathlib import Path

import pytest

import numpy as np

from pathtracer.integrator.render import Renderer
from pathtracer.utils.config import RenderOptions, SampleMode

REPO_SCENES = Path(__file__).resolve().parent.parent / "scenes"


def test_batched_iterations_bit_identical(scenes_dir):
    base = RenderOptions(sample_mode=SampleMode.MIS)
    r1 = Renderer(
        str(scenes_dir / "cornell.txt"),
        opts=replace(base, iters_per_dispatch=1),
        resolution=(32, 24), trace_depth=4,
    )
    r2 = Renderer(
        str(scenes_dir / "cornell.txt"),
        opts=replace(base, iters_per_dispatch=4),
        resolution=(32, 24), trace_depth=4,
    )
    # 7 = compile iter + one k=4 batch + 2 singles: covers every branch
    r1.step(7)
    r2.step(7)
    assert r1.iteration == r2.iteration == 7
    assert np.array_equal(np.asarray(r1.img), np.asarray(r2.img))
    # stats: the compile window books 1 (unbatched) vs 1+4 (batched
    # variant compile) iterations; the rest are timed
    assert r1.stats.iterations_done == r2.stats.iterations_done == 7


def test_batched_mesh_kernel_bit_identical(tmp_path, kernel_walk):
    """The fused mesh path through the traversal kernel (interpret mode on
    CPU) must be bit-identical batched vs unbatched too — this is the path
    GPU mesh scenes take with the auto k=2."""
    from tests.test_traverse import tri_soup_scene

    path = tri_soup_scene(tmp_path, n=200, seed=5)
    base = RenderOptions(sample_mode=SampleMode.MIS)
    r1 = Renderer(path, opts=replace(base, iters_per_dispatch=1),
                  resolution=(16, 8), trace_depth=2)
    r2 = Renderer(path, opts=replace(base, iters_per_dispatch=2),
                  resolution=(16, 8), trace_depth=2)
    assert r1.traversal == "kernel" and not r1.staged and not r2.staged
    assert r2._k == 2
    r1.step(3)
    r2.step(3)
    assert r1.iteration == r2.iteration == 3
    assert np.array_equal(np.asarray(r1.img), np.asarray(r2.img))


def test_auto_k_analytic_vs_mesh(scenes_dir):
    r = Renderer(
        str(scenes_dir / "cornell.txt"),
        opts=RenderOptions(), resolution=(16, 16), trace_depth=2,
    )
    assert r._k == 8  # analytic scene: dispatch-bound, batch by default
    rm = Renderer(
        str(REPO_SCENES / "glassbunny.txt"),
        opts=RenderOptions(), resolution=(16, 16), trace_depth=2,
    )
    # mesh scene on CPU takes the XLA walk on the STAGED path -> no
    # batching (on the GPU the fused kernel path gets auto k=2)
    assert rm.traversal == "xla" and rm.staged and rm._k == 1
