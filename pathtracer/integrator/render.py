"""Progressive renderer: accumulation loop, tonemapped save, checkpointing.

Rebuild of the reference's host orchestration (reference: src/main.cpp:146-226
runCuda/saveImage): dev_image accumulates radiance sums across iterations,
display/save divides by the iteration count then applies ACES + gamma 1/2.2
and an X mirror (reference: src/main.cpp:151-158, src/pathtrace.cu:32-65).

Beyond the reference (SURVEY.md §5 'checkpoint/resume'): the accumulation
buffer + iteration count + RNG seed are saveable/loadable, so a render can
resume exactly (counter-based RNG keyed on iteration makes the resumed
stream identical to an uninterrupted run).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

from pathtracer.integrator.wavefront import CameraArrays, make_render_iteration
from pathtracer.ops.traverse import resolve_traversal
from pathtracer.ops import math as m
from pathtracer.scene.camera import RenderCamera, derive_camera
from pathtracer.scene.flatscene import build_flat_scene
from pathtracer.scene.parser import SceneData, load_scene
from pathtracer.utils import rng
from pathtracer.utils import jaxcache
from pathtracer.utils.config import RenderOptions, SampleMode
from pathtracer.utils.image_io import write_hdr, write_png


def swizzle_map(width: int, height: int, block: int = 32) -> np.ndarray:
    """Lane→pixel permutation grouping pixels into `block`² tiles."""
    idx = np.arange(width * height, dtype=np.int64)
    x = idx % width
    y = idx // width
    blocks_x = (width + block - 1) // block
    key = ((y // block) * blocks_x + (x // block)) * (block * block) + (
        y % block
    ) * block + (x % block)
    return np.argsort(key, kind="stable")


@dataclass
class RenderStats:
    iterations_done: int = 0
    rays_traced: int = 0
    wall_seconds: float = 0.0
    compile_seconds: float = 0.0
    per_iter_seconds: list = field(default_factory=list)

    @property
    def mrays_per_sec(self) -> float:
        t = self.wall_seconds
        return (self.rays_traced / t / 1e6) if t > 0 else 0.0


class Renderer:
    """Owns the jitted iteration fn + accumulation state for one scene."""

    def __init__(
        self,
        scene: SceneData | str | Path,
        opts: RenderOptions | None = None,
        resolution: tuple[int, int] | None = None,
        trace_depth: int | None = None,
        devices: int | None = None,
    ):
        """`devices > 1` renders pixel-row-sharded over a `jax.sharding.Mesh`
        of that many devices (parallel/sharding.py); the position-keyed RNG
        makes the result equal to a single-device render without the pixel
        swizzle.  The swizzle (on by default for triangle scenes) keys the
        RNG by lane, so a swizzled single-device render draws other samples
        for each pixel: the same image in distribution, not bit for bit."""
        jaxcache.enable()
        if not isinstance(scene, SceneData):
            scene = load_scene(scene)
        self.scene = scene
        self.opts = opts or RenderOptions()
        if resolution is not None:
            scene.camera.resolution = resolution
        if trace_depth is not None:
            scene.trace_depth = trace_depth
        self.flat, self.static = build_flat_scene(scene, opts=self.opts)
        self.width, self.height = scene.camera.resolution
        self.camera: RenderCamera = derive_camera(scene.camera)
        # the triangle BVH walk: the per-ray kernel on the GPU, the XLA
        # walk on the CPU (ops/traverse.resolve_traversal)
        self.traversal = resolve_traversal(self.opts.traversal, jax.default_backend())
        self.devices = int(devices) if devices else 1
        self._k = 1  # iterations per dispatch (fused single-device only)
        self._regen = 0  # samples/pixel per persistent-pool batch (0 = off)
        # spatial swizzle: lane l renders pixel pixel_order[l], so lanes
        # that trace together cover square 32x32 blocks instead of row
        # strips; the image is unswizzled at readout.  The sharded pool is
        # row-partitioned instead, so swizzle is off there.
        self.pixel_order = None
        pixel_xy = None
        if self.devices == 1 and self.opts.swizzle and self.static.num_tris > 0:
            self.pixel_order = swizzle_map(self.width, self.height)
            xs = jnp.asarray((self.pixel_order % self.width).astype(np.float32))
            ys = jnp.asarray((self.pixel_order // self.width).astype(np.float32))
            pixel_xy = (xs, ys)
        if self.devices > 1:
            # the sharded step trades two single-device features for
            # simplicity: the 32x32 pixel swizzle is off (the pool is
            # row-partitioned across devices, so a global pixel permutation
            # would break the shard boundaries), and the step is always
            # fused (no shrink ladder / staged path).  The bitwise-equality
            # tests (test_sharding.py) cover correctness.
            from pathtracer.parallel import sharding as sh

            self._sh = sh
            self.mesh = sh.make_mesh(self.devices)
            self._sharded_step, self._img_sharding, self._padded_h = (
                sh.make_sharded_iteration(
                    self.static, self.opts, self.width, self.height, self.mesh
                )
            )
            self.staged = False
        else:
            builder = make_render_iteration(
                self.static, self.opts, self.width, self.height, pixel_xy=pixel_xy
            )
            # Triangle scenes on the XLA walk run STAGED (host loop over
            # jitted bounce stages), which keeps the BVH while_loop out of
            # the bounce while_loop.  With the traversal kernel or no
            # triangles at all, the fused single-dispatch path runs.
            self.staged = self.static.num_tris > 0 and self.traversal == "xla"
            # cross-iteration ray regeneration (see RenderOptions.ray_regen):
            # fused multi-bounce paths only — the persistent pool refills
            # dead lanes with next-sample camera rays inside the while loop
            rk = int(getattr(self.opts, "ray_regen", 0))
            if (
                rk > 1
                and not self.staged
                and self.opts.sample_mode != SampleMode.DIRECT_LI
                and not self.opts.show_normal
            ):
                self._regen = rk
                self._batch_fn = jax.jit(
                    make_render_iteration(
                        self.static, self.opts, self.width, self.height,
                        pixel_xy=pixel_xy, regen_k=rk,
                    )
                )
            if self.staged:
                self._start_fn = jax.jit(builder.start_state)
                self._bounce_fn = jax.jit(builder.bounce_step)
                self._finish_fn = jax.jit(builder.finish_state)
            else:
                self._iter_fn = jax.jit(builder)
                # iteration batching: k iterations per jit call, as k
                # SEQUENTIAL bounce loops (not nested), to amortize the
                # per-dispatch latency.  Bit-identical: RNG keys on
                # (iteration, lane).  auto: 8 for analytic scenes, 2 for
                # triangle scenes; both still to be measured on the GPU
                # (ROADMAP S10).
                k = int(self.opts.iters_per_dispatch) or (
                    8 if self.static.num_tris == 0 else 2
                )
                self._k = max(k, 1)
                if self._k > 1:
                    kk = self._k

                    def _body_k(flat, cam, img, it0, key):
                        rays = jnp.float32(0)
                        depth = jnp.int32(0)
                        for i in range(kk):
                            img, rr, depth = builder(
                                flat, cam, img, it0 + jnp.int32(i), key
                            )
                            rays = rays + rr.astype(jnp.float32)
                        return img, rays, depth

                    self._iter_fn_k = jax.jit(_body_k)
        self.seed = 0
        self.key = rng.base_key(0)
        self.traced_depth = 0  # live depth reached last iteration
        self.cam_position = None  # interactive pan/zoom override (None = scene)
        self.reset()
        self.stats = RenderStats()

    def set_seed(self, seed: int):
        self.seed = int(seed)
        self.key = rng.base_key(self.seed)

    def _run_iteration(self, cam, iteration):
        """One progressive sample per pixel; returns (img, rays, depth)."""
        it = jnp.int32(iteration)
        if self.devices > 1:
            return self._sharded_step(self.flat, cam, self.img, it, self.key)
        if not self.staged:
            return self._iter_fn(self.flat, cam, self.img, it, self.key)
        state = self._start_fn(self.flat, cam, self.img, it, self.key)
        laps = 0
        for _ in range(self.static.trace_depth + 1):
            state, alive = self._bounce_fn(self.flat, self.key, it, state)
            laps += 1
            if int(alive) == 0:
                break
        return self._finish_fn(state, self.flat), state.rays_traced, laps

    # -- state --------------------------------------------------------------
    def reset(self):
        """Restart accumulation (the reference's camchanged path,
        reference: src/main.cpp:173-201)."""
        if self.devices > 1:
            self.img = self._sh.zeros_image(self.width, self.height, self.mesh)
        else:
            n = self.width * self.height
            self.img = jnp.zeros((n, 3), jnp.float32)
        self.iteration = 0

    def set_orbit(self, theta: float, phi: float):
        """Interactive orbit — rotates the view basis, position unchanged
        (reference: src/main.cpp:255-261 left drag + :173-193 rebuild)."""
        self.camera = derive_camera(
            self.scene.camera, theta=theta, phi=phi, position=self.cam_position
        )
        self.reset()

    def pan(self, dx_px: float, dy_px: float):
        """Middle-drag translate along the ground-projected right/forward
        axes, 0.01 world units per pixel (reference: src/main.cpp:268-281)."""
        fwd = np.array(self.camera.view, np.float64)
        fwd[1] = 0.0
        fwd /= max(np.linalg.norm(fwd), 1e-12)
        right = np.array(self.camera.right, np.float64)
        right[1] = 0.0
        right /= max(np.linalg.norm(right), 1e-12)
        pos = np.array(self.camera.position, np.float64)
        pos -= dx_px * right * 0.01
        pos += dy_px * fwd * 0.01
        self.cam_position = tuple(float(x) for x in pos)
        self.camera = derive_camera(
            self.scene.camera, theta=self.camera.theta, phi=self.camera.phi,
            position=self.cam_position,
        )
        self.reset()

    def zoom(self, dy_frac: float):
        """Right-drag dolly along the view direction.

        The reference tracks `zoom += dy/height` (src/main.cpp:263-266) but
        the code that applies it to the camera position is commented out
        (src/main.cpp:174-190) — right drag only resets accumulation there.
        We implement the evident intent: dolly by the same magnitude.
        """
        pos = np.array(self.camera.position, np.float64)
        pos -= np.array(self.camera.view, np.float64) * dy_frac
        self.cam_position = tuple(float(x) for x in pos)
        self.camera = derive_camera(
            self.scene.camera, theta=self.camera.theta, phi=self.camera.phi,
            position=self.cam_position,
        )
        self.reset()

    def _cam_arrays(self) -> CameraArrays:
        p, v, u, r, pl = self.camera.as_arrays()
        return CameraArrays(
            position=jnp.asarray(p),
            view=jnp.asarray(v),
            up=jnp.asarray(u),
            right=jnp.asarray(r),
            pixel_length=jnp.asarray(pl),
        )

    # -- rendering ----------------------------------------------------------
    def step(self, num_iterations: int = 1) -> RenderStats:
        if self._regen:
            return self._step_regen(num_iterations)
        cam = self._cam_arrays()
        first = self.iteration == 0 and self.stats.compile_seconds == 0.0
        if first:
            t0 = time.perf_counter()
            img, rays, depth = self._run_iteration(cam, self.iteration + 1)
            self.traced_depth = int(depth)
            jax.block_until_ready(img)
            self.img = img
            self.iteration += 1
            self.stats.iterations_done += 1
            # the compile iteration's rays are NOT booked: its wall time
            # goes to compile_seconds, so counting them would inflate
            # mrays_per_sec for short renders
            num_iterations -= 1
            if self._k > 1:
                # compile-only warmup of the k-batched variant (result
                # DISCARDED), so its compile never lands in a timed
                # window and step(n) still advances exactly n iterations
                wimg, _, _ = self._iter_fn_k(
                    self.flat, cam, self.img,
                    jnp.int32(self.iteration + 1), self.key,
                )
                jax.block_until_ready(wimg)
            self.stats.compile_seconds = time.perf_counter() - t0

        t0 = time.perf_counter()
        # accumulate on device in f32 (int32 overflows beyond ~2e9 rays;
        # x64 is off by default)
        rays_total = jnp.float32(0)
        depth = None
        booked = num_iterations
        while self._k > 1 and num_iterations >= self._k:
            self.img, rays, depth = self._iter_fn_k(
                self.flat, cam, self.img,
                jnp.int32(self.iteration + 1), self.key,
            )
            rays_total = rays_total + rays  # already f32 in-graph
            self.iteration += self._k
            num_iterations -= self._k
        for _ in range(num_iterations):
            self.img, rays, depth = self._run_iteration(cam, self.iteration + 1)
            rays_total = rays_total + rays.astype(jnp.float32)
            self.iteration += 1
        jax.block_until_ready(self.img)
        if depth is not None:
            # live traced depth (reference: src/pathtrace.cu:793-796)
            self.traced_depth = int(depth)
        dt = time.perf_counter() - t0
        self.stats.iterations_done += max(booked, 0)
        self.stats.rays_traced += int(rays_total)
        self.stats.wall_seconds += dt
        if booked > 0:
            self.stats.per_iter_seconds.append(dt / booked)
        return self.stats

    def _step_regen(self, num_iterations: int) -> RenderStats:
        """Progressive sampling through the persistent regeneration pool:
        batches of up to `ray_regen` samples/pixel per dispatch.  The batch
        size `nk` is a TRACED argument, so one compiled executable serves
        every batch size (incl. the 1-sample warmup and any tail
        remainder)."""
        cam = self._cam_arrays()
        first = self.iteration == 0 and self.stats.compile_seconds == 0.0
        if first:
            t0 = time.perf_counter()
            img, rays, depth = self._batch_fn(
                self.flat, cam, self.img, jnp.int32(self.iteration + 1),
                self.key, jnp.int32(1),
            )
            self.traced_depth = int(depth)
            jax.block_until_ready(img)
            self.img = img
            self.iteration += 1
            self.stats.iterations_done += 1
            # compile iteration's rays are NOT booked (see step())
            num_iterations -= 1
            self.stats.compile_seconds = time.perf_counter() - t0

        t0 = time.perf_counter()
        rays_total = jnp.float32(0)
        depth = None
        booked = num_iterations
        while num_iterations > 0:
            nk = min(num_iterations, self._regen)
            self.img, rays, depth = self._batch_fn(
                self.flat, cam, self.img, jnp.int32(self.iteration + 1),
                self.key, jnp.int32(nk),
            )
            rays_total = rays_total + rays.astype(jnp.float32)
            self.iteration += nk
            num_iterations -= nk
        jax.block_until_ready(self.img)
        if depth is not None:
            self.traced_depth = int(depth)
        dt = time.perf_counter() - t0
        self.stats.iterations_done += max(booked, 0)
        self.stats.rays_traced += int(rays_total)
        self.stats.wall_seconds += dt
        if booked > 0:
            self.stats.per_iter_seconds.append(dt / booked)
        return self.stats

    # -- output -------------------------------------------------------------
    def _unswizzle(self, img_lane: np.ndarray) -> np.ndarray:
        if self.devices > 1:
            # row-sharded pool: lanes are already pixel-ordered; drop the
            # mesh-divisibility padding rows
            return img_lane[: self.width * self.height]
        if self.pixel_order is None:
            return img_lane
        out = np.empty_like(img_lane)
        out[self.pixel_order] = img_lane
        return out

    def ldr_image(self) -> np.ndarray:
        """Tonemapped (H, W, 3) float in [0,1], reference display transform
        WITHOUT the save-time X mirror (reference: src/pathtrace.cu:45-50)."""
        avg = self.img / max(self.iteration, 1)
        if self.opts.tonemapping:
            ldr = m.gamma_correction(m.aces_film(avg))
        else:
            ldr = jnp.clip(avg, 0.0, 1.0)
        return self._unswizzle(np.asarray(ldr)).reshape(self.height, self.width, 3)

    def save_png(self, path: str | Path, mirror_x: bool = True):
        """reference: src/main.cpp:146-170 saveImage (X-mirrored)."""
        img = self.ldr_image()
        if mirror_x:
            img = img[:, ::-1]
        write_png(path, img)

    def save_hdr(self, path: str | Path, mirror_x: bool = True):
        avg = self._unswizzle(
            np.asarray(self.img / max(self.iteration, 1))
        ).reshape(self.height, self.width, 3)
        if mirror_x:
            avg = avg[:, ::-1]
        write_hdr(path, avg)

    # -- checkpoint/resume ---------------------------------------------------
    def save_checkpoint(self, path: str | Path):
        path = Path(path)
        np.savez_compressed(
            path,
            img=np.asarray(self.img),
            iteration=self.iteration,
            theta=self.camera.theta,
            phi=self.camera.phi,
            meta=json.dumps(
                {
                    "scene": str(self.scene.path),
                    "width": self.width,
                    "height": self.height,
                    "mode": int(self.opts.sample_mode),
                    "seed": self.seed,
                    # the accumulator is LANE-ordered; loading under a
                    # different pixel mapping would scramble the image
                    "swizzled": self.pixel_order is not None,
                    # sharded accumulators carry mesh-padding rows
                    "devices": self.devices,
                }
            ),
        )

    def load_checkpoint(self, path: str | Path):
        data = np.load(path, allow_pickle=False)
        meta = json.loads(str(data["meta"]))
        if (meta["width"], meta["height"]) != (self.width, self.height):
            raise ValueError("checkpoint resolution mismatch")
        if meta.get("swizzled", False) != (self.pixel_order is not None):
            raise ValueError(
                "checkpoint pixel-order mismatch (saved with a different "
                "swizzle setting)"
            )
        # resuming with a different estimator or RNG stream would silently
        # blend two different sequences into one accumulator
        if "mode" in meta and meta["mode"] != int(self.opts.sample_mode):
            raise ValueError(
                f"checkpoint sample-mode mismatch (saved mode {meta['mode']}, "
                f"current {int(self.opts.sample_mode)})"
            )
        if "seed" in meta and int(meta["seed"]) != self.seed:
            raise ValueError(
                f"checkpoint RNG-seed mismatch (saved seed {meta['seed']}, "
                f"current {self.seed})"
            )
        if int(meta.get("devices", 1)) != self.devices:
            raise ValueError(
                f"checkpoint device-count mismatch (saved {meta.get('devices', 1)}, "
                f"current {self.devices}) — the lane padding differs"
            )
        if self.devices > 1:
            self.img = jax.device_put(jnp.asarray(data["img"]), self._img_sharding)
        else:
            self.img = jnp.asarray(data["img"])
        self.iteration = int(data["iteration"])
        self.camera = derive_camera(
            self.scene.camera, theta=float(data["theta"]), phi=float(data["phi"])
        )


def render_scene(
    scene_path: str | Path,
    spp: int | None = None,
    mode: SampleMode = SampleMode.BSDF,
    resolution: tuple[int, int] | None = None,
    trace_depth: int | None = None,
    out: str | Path | None = None,
    opts: RenderOptions | None = None,
) -> tuple[Renderer, RenderStats]:
    """One-call headless render (the CLI's core)."""
    opts = (opts or RenderOptions()).with_mode(mode)
    r = Renderer(scene_path, opts=opts, resolution=resolution, trace_depth=trace_depth)
    n = spp if spp is not None else r.static.iterations
    stats = r.step(n)
    if out is not None:
        r.save_png(out)
    return r, stats
