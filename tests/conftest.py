"""Test config: force CPU JAX with 8 virtual devices for sharding tests.

Per SURVEY.md §4: multi-host fakes are unnecessary; CPU jax with
--xla_force_host_platform_device_count suffices to exercise sharded code.
The scenes are the in-repo ones; their seeded assets are generated once
per session (pathtracer/scene/assets.py).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax

jax.config.update("jax_platforms", "cpu")

import pytest

from pathtracer.scene.assets import ensure_assets

SCENES = pathlib.Path(__file__).resolve().parent.parent / "scenes"


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run the heavy cross-check tests (oracle cross-RMSE, "
        "8-device sharding end-to-end, furnace integrals)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy cross-check (skipped by default; enable with "
        "--runslow — the full pyramid runs at round end)",
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow test: pass --runslow to include")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(scope="session", autouse=True)
def generated_assets():
    """The seeded mesh/texture/env files the in-repo scenes reference."""
    return ensure_assets()


@pytest.fixture(scope="session")
def scenes_dir():
    return SCENES


@pytest.fixture
def kernel_walk(monkeypatch):
    """The GPU's choice of triangle walk, on the CPU: `traversal="auto"`
    resolves to the traversal kernel, whose body runs in interpret mode."""
    import functools

    from pathtracer.integrator import render, wavefront
    from pathtracer.ops import traverse, traverse_kernel

    def as_on_gpu(choice, platform):
        return traverse.resolve_traversal(choice, "gpu")

    for mod in (render, wavefront):
        monkeypatch.setattr(mod, "resolve_traversal", as_on_gpu)
    for name in ("closest_hit_kernel", "occlusion_kernel"):
        kernel = getattr(traverse_kernel, name)
        monkeypatch.setattr(traverse_kernel, name, functools.partial(kernel, interpret=True))
