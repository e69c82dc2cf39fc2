"""Profiling & observability.

The reference's profiling story is commented-out QueryPerformanceCounter
timers and an empty nsight capture (SURVEY.md §5); its live metrics are the
ImGui ms/frame + traced-depth panel (reference: src/preview.cpp:222-226).
Here: wall-clock stage timers with block_until_ready, a rays/s meter, and a
wrapper around jax.profiler for Perfetto/Tensorboard traces.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class StageTimer:
    """Accumulating per-stage wall-clock timer (device-synchronized)."""

    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time a stage; pass `sync=arr` to block on a device value."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            import jax

            jax.block_until_ready(sync)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:24s} {t*1000:9.2f} ms total  {t/c*1000:8.2f} ms/call x{c}")
        return "\n".join(lines)


class RaysPerSecond:
    """Sliding throughput meter (the FPS counter of the headless renderer)."""

    def __init__(self, window: int = 16):
        self.window = window
        self.samples: list[tuple[float, int]] = []

    def add(self, wall_seconds: float, rays: int):
        self.samples.append((wall_seconds, rays))
        if len(self.samples) > self.window:
            self.samples.pop(0)

    @property
    def mrays_per_sec(self) -> float:
        t = sum(s for s, _ in self.samples)
        r = sum(r for _, r in self.samples)
        return r / t / 1e6 if t > 0 else 0.0


@contextlib.contextmanager
def device_trace(out_dir: str = "chiprun_out/trace"):
    """Capture a jax.profiler trace (open in Perfetto/TensorBoard)."""
    import jax

    with jax.profiler.trace(out_dir):
        yield
    print(f"profiler trace written to {out_dir}")


def top_ops_from_trace(trace_dir: str, top: int = 20) -> list[tuple[float, str]]:
    """Parse a jax.profiler trace dir → [(total_ms, op_name)] hottest first."""
    import collections
    import glob
    import gzip
    import json

    files = sorted(glob.glob(f"{trace_dir}/**/*.trace.json.gz", recursive=True))
    if not files:
        return []
    events = json.load(gzip.open(files[-1]))["traceEvents"]
    dur = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and "dur" in e and not e.get("name", "").startswith("$"):
            dur[e["name"]] += e["dur"]
    return [(d / 1000.0, name) for name, d in dur.most_common(top)]
