"""The driver-checked deliverables must work from ANY host process state.

dryrun_multichip is hermetic (a subprocess with a forced-CPU environment),
so it must not depend on the backends the calling process has live.  This
test runs it from inside the pytest process (which itself has jax-on-CPU
live) to pin the subprocess isolation.
"""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import __graft_entry__ as graft


@pytest.mark.slow
def test_dryrun_multichip_hermetic():
    # 4 devices keeps the CPU compile short; the driver runs 8.
    graft.dryrun_multichip(4)


def test_dryrun_multichip_smoke():
    """Default-tier guard for the driver-run invariant (ADVICE r4): the
    hermetic subprocess machinery + pixel- and sample-space sharding on 2
    devices, analytic scene only (the mesh pass is the slow
    part and stays in the --runslow variant above)."""
    graft.dryrun_multichip(2, fast=True)


def test_entry_compiles():
    import jax

    fn, args = graft.entry()
    img, rays, depth = jax.jit(fn)(*args)
    jax.block_until_ready(img)
    assert img.shape == (64 * 64, 3)
    assert int(rays) > 0
    assert int(depth) >= 1
