"""Renderer: owns the device scene, the active environment, the film and
the camera, and drives the render loop (port of
rsoderh_raytracing_tpu/render/renderer.py).

It steps per sample with the reference's state-hash reset: a moved
camera, another environment or another resolution starts the film anew.
``step`` runs the scan integrator, ``step_batch`` and ``step_freerun``
the wavefront; all three accumulate the same per-(pixel, sample) streams.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from rsoderh_raytracing_tpu_torch import _device, tracing
from rsoderh_raytracing_tpu_torch.env.environment import (
    EnvironmentMaps,
    device_environment,
    load_default_environments,
)
from rsoderh_raytracing_tpu_torch.env.hdr_io import write_hdr
from rsoderh_raytracing_tpu_torch.ops import envmap, rng
from rsoderh_raytracing_tpu_torch.render.film import Film
from rsoderh_raytracing_tpu_torch.render.integrator import (
    MAX_BOUNCES,
    camera_pytree,
    render_sample,
)
from rsoderh_raytracing_tpu_torch.render.wavefront import render_freerun, render_wavefront
from rsoderh_raytracing_tpu_torch.scene.device import BVH, build_device_scene, route
from rsoderh_raytracing_tpu_torch.scene.types import Scene
from rsoderh_raytracing_tpu_torch.utils.png import write_png


def host_stats(stats) -> dict:
    """A call's device counters (rays traced, iterations run, the closest
    rays BVH_CLOSEST's fallback swept) on the host, in one copy: one sync
    on the card (the span renderer.stats, sync.stats; the counter
    bvh.fallback_lanes adds the swept lanes)."""
    with tracing.span("renderer.stats"):
        tracing.count("sync.stats")
        keys = ("closest_rays", "shadow_rays", "iterations", "fallback_lanes")
        closest, shadow, iterations, fallback = torch.stack([stats[k] for k in keys]).cpu().tolist()
        if fallback:
            tracing.count("bvh.fallback_lanes", fallback)
        return {
            "closest_rays": float(closest),
            "shadow_rays": float(shadow),
            "iterations": int(iterations),
            "fallback_lanes": int(fallback),
        }


class Renderer:
    def __init__(
        self,
        scene: Scene,
        width: int = 512,
        height: int = 512,
        environments: Optional[EnvironmentMaps] = None,
        max_bounces: int = MAX_BOUNCES,
        intersector: str = "auto",
        device=_device.DEFAULT,
    ):
        """intersector: 'sweep' takes the sweep kernels, whatever the
        scene: the chunked route where it covers the scene, else the small
        route's packed table (staged in a block's shared memory where it
        fits, read from global memory otherwise), where the reference
        sweeps densely in XLA; 'bvh' builds the SAH BVH and walks it
        (BVH_CLOSEST, BVH_ANY); 'auto' takes the route the device
        measures as fastest: on the card the BVH past CUDA_BVH_ABOVE_LANES
        (192) padded sphere and triangle lanes, where the walks overtake
        the chunked kernels, or where the small route's table would not
        fit a block's shared memory; on the CPU the reference's rule, past
        262,144 triangle lanes (RT_BVH_ABOVE_TRIS=N lowers the crossover:
        scene/device.auto_bvh). device: the card unless the caller asks
        for the CPU."""
        if intersector not in ("auto", "sweep", "bvh"):
            raise ValueError(f"unknown intersector '{intersector}'")
        self.device = _device.resolve(device)
        self.scene = scene
        self.width = width
        self.height = height
        self.max_bounces = max_bounces
        self.device_scene = build_device_scene(
            scene, self.device, with_bvh={"auto": "auto", "bvh": True, "sweep": False}[intersector])
        #: the routing decision actually taken: 'bvh', or 'sweep' (the
        #: small or chunked route), as the reference reports it
        self.intersector = "bvh" if route(self.device_scene) == BVH else "sweep"
        self.environments = environments or load_default_environments()
        self.environment_index = 0
        self._device_env_cache: dict[int, object] = {}
        self._alias_scatter_cache: Optional[tuple] = None
        self.camera = scene.camera
        self.film = Film(width, height, self.device)
        self._last_state_hash: Optional[tuple] = None
        self.last_stats: Optional[dict] = None

    # -- state hash / progressive reset (src/state.rs:774-789) -------------

    def _state_hash(self) -> tuple:
        return (
            self.camera.state_hash(),
            self.environment_index,
            self.width,
            self.height,
        )

    def _reset_if_changed(self) -> None:
        state_hash = self._state_hash()
        if state_hash != self._last_state_hash:
            with tracing.span("renderer.reset"):
                self.film.reset()
            self._last_state_hash = state_hash

    def _device_env(self):
        idx = self.environment_index
        if idx not in self._device_env_cache:
            self._device_env_cache[idx] = device_environment(self.environments[idx], self.device)
        return self._device_env_cache[idx]

    def _camera(self):
        return camera_pytree(self.camera, self.device)

    def next_environment(self) -> int:
        self.environment_index = self.environments.next_index(self.environment_index)
        return self.environment_index

    def resize(self, width: int, height: int) -> None:
        self.width = width
        self.height = height
        self.film.resize(width, height)
        self._last_state_hash = None

    # -- stepping -----------------------------------------------------------

    def step(self) -> int:
        """Render one progressive sample through the scan integrator;
        resets the accumulation if the camera, environment or resolution
        changed. Returns the sample count."""
        self._reset_if_changed()
        sample = render_sample(
            self.device_scene, self._device_env(), self._camera(),
            self.film.sample_count, (self.width, self.height), self.max_bounces,
        )
        self.film.add_sample(sample)
        return self.film.sample_count

    def step_batch(self, spp: int) -> int:
        """Render `spp` progressive samples in one wavefront call: the
        same accumulation as `spp` step() calls."""
        self._reset_if_changed()
        summed = render_wavefront(
            self.device_scene, self._device_env(), self._camera(),
            self.film.sample_count, (self.width, self.height), spp, self.max_bounces,
        )
        self.film.add_samples(summed, spp)
        return self.film.sample_count

    @tracing.traced("renderer.step_freerun")
    def step_freerun(self, iterations: int, compact_every: int | None = None) -> int:
        """Run the iteration-budget wavefront: every lane stays busy for
        `iterations` path segments, so the per-pixel sample count varies.
        Returns the minimum per-pixel sample count; ``last_stats`` holds
        the rays traced in this step. compact_every is the chunked route's
        lane compaction cadence (render_freerun; None: its default).
        Traced as the root span of a call (tracing.py)."""
        self._reset_if_changed()
        summed, counts, stats = render_freerun(
            self.device_scene, self._device_env(), self._camera(),
            self.film.counts,  # stays on the device
            (self.width, self.height), iterations, self.max_bounces, with_stats=True,
            compact_every=compact_every,
        )
        self.film.add_freerun(summed, counts)
        self.last_stats = host_stats(stats)
        return self.film.sample_count

    def render(
        self,
        spp: int = 16,
        progress: bool = False,
        batch: int | None = None,
        mode: str = "exact",
    ) -> np.ndarray:
        """Render until every pixel has >= `spp` samples; returns the
        tonemapped image (H, W, 3) in linear [0, 1].

        mode="exact": every pixel gets exactly `spp` samples, in
        wavefront batches of `batch` (one batch by default; batch=1
        forces the per-sample scan integrator).
        mode="freerun": the iteration-budget wavefront; cheap pixels
        exceed `spp`, and it loops until the minimum count reaches it.
        """
        start = time.perf_counter()
        if mode == "freerun":
            # about 3.5 segments a sample on typical scenes
            while self.film.sample_count < spp:
                remaining = spp - self.film.sample_count
                self.step_freerun(max(16, remaining * 4))
                if progress:
                    elapsed = time.perf_counter() - start
                    done = self.film.sample_count
                    print(f"  min spp {done}/{spp}  ({done / max(elapsed, 1e-9):.2f} spp/s)")
            return self.film.tonemapped()
        if mode != "exact":
            raise ValueError(f"unknown mode '{mode}'")

        if self.film.sample_count and not self.film.is_uniform:
            raise ValueError(
                "exact mode cannot extend a non-uniform (free-run)"
                " accumulation: pixels above the per-pixel minimum would"
                " have sample indices re-rendered (their deterministic"
                " radiance added twice). Use mode='freerun'."
            )
        # `spp` is the TOTAL target: resuming a 64-spp checkpoint with
        # spp=64 renders nothing more.
        done = self.film.sample_count
        if batch is None:
            batch = max(spp, 1)
        while done < spp:
            n = min(batch, spp - done)
            if n == 1 and batch == 1:
                self.step()
            else:
                self.step_batch(n)
            done += n
            if progress:
                elapsed = time.perf_counter() - start
                print(f"  sample {done}/{spp}  ({done / max(elapsed, 1e-9):.2f} spp/s)")
        return self.film.tonemapped()

    def save_png(self, path: str) -> None:
        write_png(path, self.film.srgb8())

    def save_hdr(self, path: str) -> None:
        """Write the LINEAR mean radiance as a Radiance .hdr file, through
        the RGBE codec that loads environments (env/hdr_io.py)."""
        write_hdr(path, np.asarray(self.film.mean_radiance(), np.float32))

    def _state_stamp(self) -> np.ndarray:
        """Render-state identity that holds across processes and across
        the two packages: the camera's raw f32 bits, the environment
        index and the resolution."""
        cam_bits = np.frombuffer(
            np.concatenate(
                [
                    np.asarray(self.camera.pos, np.float32),
                    np.asarray(
                        [self.camera.yaw, self.camera.pitch, self.camera.fov_y], np.float32
                    ),
                ]
            ).tobytes(),
            dtype=np.uint32,
        )
        return np.concatenate(
            [
                cam_bits.astype(np.int64),
                np.asarray([self.environment_index, self.width, self.height], np.int64),
            ]
        )

    def save_checkpoint(self, path: str) -> None:
        """Accumulation checkpoint stamped with the render state it was
        produced under."""
        self.film.save_checkpoint(path, state_stamp=self._state_stamp())

    def load_checkpoint(self, path: str) -> None:
        """Load an accumulation checkpoint. Refuses one whose state stamp
        differs from the current camera, environment and resolution:
        blending two states double-exposes. A checkpoint without a stamp
        loads as it is."""
        self._check_state_stamp(path)
        self.film.load_checkpoint(path)

    def _check_state_stamp(self, path: str) -> None:
        with np.load(path) as z:
            saved = z["state_stamp"] if "state_stamp" in z.files else None
        if saved is not None and not np.array_equal(saved, self._state_stamp()):
            raise ValueError(
                f"checkpoint {path} was accumulated under a different"
                " camera/environment/resolution state; pass the matching"
                " --state (the camera string printed when it was saved)"
                " or render fresh — blending states would double-expose"
            )

    # -- dev debug views (reference shader.wgsl:1314-1338) ------------------

    def debug_alias_scatter(self, draws_per_pixel: int = 20, sample_index: int = 0) -> np.ndarray:
        """Scatter-plot the alias-table distribution with the device RNG
        (shader.wgsl:1314-1332): each screen pixel seeds its (pixel,
        sample) stream and draws `draws_per_pixel` alias samples, two
        uniforms each; every draw adds 0.1/n at the drawn environment
        pixel. Static for given inputs, so cached."""
        key = (self.environment_index, draws_per_pixel, sample_index, self.width, self.height)
        if self._alias_scatter_cache is not None and self._alias_scatter_cache[0] == key:
            return self._alias_scatter_cache[1]
        denv = self._device_env()
        env = self.environments[self.environment_index]
        length = env.width * env.height
        pix = torch.arange(self.width * self.height, dtype=torch.int64, device=self.device)
        state = rng.seed(pix, sample_index)
        hist = torch.zeros(length, dtype=torch.float32, device=self.device)
        add = torch.full((pix.shape[0],), np.float32(0.1 / draws_per_pixel),
                         dtype=torch.float32, device=self.device)
        for _ in range(draws_per_pixel):
            state, u_index = rng.next_uniform(state)
            index = torch.clamp_max(envmap.float_to_int(u_index * float(length)), length - 1)
            state, u_accept = rng.next_uniform(state)
            keep = u_accept < denv.alias_pair.index_select(0, index)[:, 0]
            final = torch.where(keep, index, denv.alias_index.index_select(0, index))
            hist.index_add_(0, final, add)
        img = hist.cpu().numpy().reshape(env.height, env.width)
        out = np.clip(img[..., None].repeat(3, axis=-1), 0.0, 1.0)
        self._alias_scatter_cache = (key, out)
        return out

    def debug_hdri_view(self) -> np.ndarray:
        """The active environment's raw HDRI, clamped."""
        return np.clip(self.environments[self.environment_index].texture, 0.0, 1.0)
