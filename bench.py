"""Benchmark runner — prints the summary JSON line, un-losably.

    python bench.py

Headline metric: Mrays/s of cornell MIS at 800x800; the other scenes'
rows follow.  Needs a GPU: it fails when JAX finds none, and prints the
card's name and power limit first.  Every scene file and asset it names
must exist (the seeded assets are generated first).

Robustness contract (a timeout while compiling a late scene must not lose
the rows already measured):
  * the headline scene (cornell MIS) runs FIRST;
  * after EVERY scene the full summary line (results so far) is printed to
    stdout and flushed — the driver takes the last line, so a kill at any
    point still leaves a valid record;
  * SIGTERM/SIGINT/SIGALRM are trapped to emit-and-exit-0 (`timeout`
    sends SIGTERM);
  * each new scene only starts while under 60% of the wall budget
    (BENCH_BUDGET_S, default 480 s), and a self-alarm fires at the budget.

Rays are counted as the reference would issue them: one primary/bounce ray
per live path per depth plus NEE shadow rays (SURVEY.md §3.3).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

_HERE = Path(__file__).resolve().parent

# Headline first: even a 1-scene run records the metric of record.  The
# analytic scenes run with cross-iteration ray regeneration
# (RenderOptions.ray_regen; one executable serves every k, the batch size
# is traced) and the mesh/env/texture scenes without it, as chosen on the
# machine this code was first tuned on; both choices and the per-scene
# window lengths are still to be measured on the GPU (ROADMAP S10).
_SC = _HERE / "scenes"
SCENES = [
    # (name, path, mode, spp, depth_override, opts_extra)
    ("cornell_mis", _SC / "cornell.txt", "mis", 32, None, {"ray_regen": 16}),
    ("cornell", _SC / "cornell.txt", "bsdf", 48, None, {"ray_regen": 16}),
    ("glassbunny", _SC / "glassbunny.txt", "mis", 8, None, {}),
    ("envbunny", _SC / "envbunny.txt", "mis", 12, None, {}),
    ("texturecube", _SC / "texturecube.txt", "mis", 16, None, {}),
    ("mis_test", _SC / "mis_test.txt", "mis", 24, None, {"ray_regen": 16}),
    ("dielectric", _SC / "dielectric_test.txt", "bsdf", 32, None,
     {"ray_regen": 16}),
]

BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "480"))
_START = time.time()
_RESULTS: list[dict] = []
_DEVICE: dict = {}


_SIGS = (signal.SIGTERM, signal.SIGINT, signal.SIGALRM)


def emit() -> None:
    """Write the full summary line from results-so-far (driver takes the
    last stdout line).  The line is built first and written with ONE
    os.write (atomic for this size), with the trapped signals blocked, so
    a signal landing mid-emit can never interleave the handler's output
    with a partially written line."""
    headline = next(
        (r for r in _RESULTS if r["scene"] == "cornell_mis"), None
    )
    line = {
        "metric": "cornell_800x800_mis_throughput",
        "value": headline["mrays_per_sec"] if headline else 0.0,
        "unit": "Mrays/s",
        "device": _DEVICE,
        "detail": list(_RESULTS),
    }
    data = (json.dumps(line) + "\n").encode()
    old = signal.pthread_sigmask(signal.SIG_BLOCK, set(_SIGS))
    try:
        sys.stdout.flush()
        os.write(1, data)
    finally:
        signal.pthread_sigmask(signal.SIG_SETMASK, old)


def _die(signum, frame):  # noqa: ARG001 - signal signature
    print(f"# bench: signal {signum} after {time.time() - _START:.0f}s, "
          f"{len(_RESULTS)} scenes done — emitting and exiting 0",
          file=sys.stderr, flush=True)
    emit()
    os._exit(0)


for _sig in _SIGS:
    signal.signal(_sig, _die)


def bench_scene(name, path, mode, spp, depth, opts_extra=None):
    from pathtracer.integrator.render import Renderer
    from pathtracer.utils.config import RenderOptions, SampleMode

    mode_map = {
        "bsdf": SampleMode.BSDF,
        "direct": SampleMode.DIRECT_LI,
        "mis": SampleMode.MIS,
    }
    r = Renderer(
        str(path),
        opts=RenderOptions(sample_mode=mode_map[mode], **(opts_extra or {})),
        trace_depth=depth,
    )
    r.step(2)  # compile + warm
    r.stats.wall_seconds = 0.0
    r.stats.rays_traced = 0
    stats = r.step(spp)
    return {
        "scene": name,
        "mode": mode,
        "traversal": r.traversal,
        "resolution": [r.width, r.height],
        "spp": spp,
        "wall_seconds": round(stats.wall_seconds, 4),
        "rays": stats.rays_traced,
        "mrays_per_sec": round(stats.mrays_per_sec, 3),
    }


def main():
    import jax

    from pathtracer.scene.assets import ensure_assets

    if jax.default_backend() != "gpu":
        print(f"bench: needs a GPU; JAX found {jax.default_backend()!r}",
              file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    _DEVICE.update(platform=dev.platform, kind=dev.device_kind,
                   count=len(jax.devices()))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    _DEVICE["card"] = smi
    print(f"# card: {smi}", file=sys.stderr, flush=True)
    ensure_assets()
    missing = [str(p) for _, p, *_ in SCENES if not Path(p).is_file()]
    if missing:
        print(f"bench: scene files missing: {missing}", file=sys.stderr)
        return 1
    signal.alarm(int(BUDGET_S))  # self-deadline inside any driver timeout
    for name, path, mode, spp, depth, opts_extra in SCENES:
        elapsed = time.time() - _START
        if _RESULTS and elapsed > 0.6 * BUDGET_S:
            print(f"# bench: skipping {name} ({elapsed:.0f}s elapsed of "
                  f"{BUDGET_S:.0f}s budget)", file=sys.stderr, flush=True)
            continue
        try:
            _RESULTS.append(bench_scene(name, path, mode, spp, depth,
                                        opts_extra))
            print(f"# {_RESULTS[-1]}", file=sys.stderr, flush=True)
        except Exception as e:  # keep the headline line emitting
            print(f"# bench {name} failed: {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)
        emit()
    if not _RESULTS:
        emit()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
