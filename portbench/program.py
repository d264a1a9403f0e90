"""The system under test, driven through its public entry points: the
port's scene loader, its environment type, ``Renderer`` (and
``ShardedRenderer.wrap`` for a mix that names devices), the resume path
of a checkpoint, ``step_freerun`` and ``film.tonemapped()``. The port is
imported here, inside functions, and nowhere else in the benchmark.

Besides the calls it times, a run reads the program's film (sums and
counts, and each card's stream position where the film is sharded) at the
pixels that the comparison checks, after each call, and with --trace 1
copies one iteration's loop state (by wrapping ``Wavefront.step`` for one
call) so that the kernels' operations can be counted on it.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from portbench import scenes
from portbench.spec import ROOT


class Program:
    """One renderer of the cell's configuration at the mix's size, resumed
    from the seeded checkpoint (render mixes) or at the scene's camera
    (frame mixes)."""

    def __init__(self, cell, args, device, tmpdir):
        from rsoderh_raytracing_tpu_torch import load_scene
        from rsoderh_raytracing_tpu_torch.env import hdr_io
        from rsoderh_raytracing_tpu_torch.env.environment import Environment, EnvironmentMaps
        from rsoderh_raytracing_tpu_torch.parallel.sharding import ShardedRenderer
        from rsoderh_raytracing_tpu_torch.render.renderer import Renderer

        config, mix = cell["config"], cell["mix"]
        self.width, self.height = args.width or mix["width"], args.height or mix["height"]
        self.bounces = args.bounces or config["max_bounces"]
        self.iterations = args.iterations or mix["iterations"]
        self.scene_file = scenes.scene_path(config)
        scene = load_scene(self.scene_file)
        env_path = os.path.join(ROOT, config["environment"])
        start = time.perf_counter()
        env = Environment.from_texture(os.path.splitext(os.path.basename(env_path))[0],
                                       hdr_io.load_image(env_path))
        self.renderer = Renderer(scene, self.width, self.height, environments=EnvironmentMaps([env]),
                                 max_bounces=self.bounces, intersector=config["intersector"], device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        self.scene_build_s = time.perf_counter() - start
        self.sharded = (ShardedRenderer.wrap(self.renderer, mix["devices"]) if mix.get("devices")
                        else None)
        self.target = self.sharded or self.renderer
        self.slots = self.sharded.mesh.shape["sample"] if self.sharded else 1
        self.cards = len(self.sharded.mesh.distinct()) if self.sharded else 1
        self.camera0 = scene.camera
        self.tmpdir = tmpdir

    # -- render mixes ---------------------------------------------------------

    def resume(self, base: np.ndarray) -> None:
        """Load a checkpoint of a zero film whose per-pixel counts are
        `base`, through the resume path the CLI takes."""
        path = os.path.join(self.tmpdir, "portbench_resume.npz")
        np.savez(path, cumulative=np.zeros((self.height, self.width, 3), np.float32),
                 counts=base.astype(np.uint32), sample_count=int(base.min()))
        inner = self.renderer
        inner._last_state_hash = inner._state_hash()
        self.target.load_checkpoint(path)
        os.remove(path)

    def call(self) -> dict:
        """One render call: step_freerun of the mix's iterations."""
        self.target.step_freerun(self.iterations)
        return self.target.last_stats

    def snapshot(self, pixel: torch.Tensor):
        """The film's sums (P, 3) and counts (P,) at `pixel`, and each
        slot's stream position (S, P) where the film is sharded (None
        before the first sharded call), left on the device."""
        film = self.renderer.film
        sums = film.cumulative.reshape(-1, 3).index_select(0, pixel)
        counts = film.counts.reshape(-1).index_select(0, pixel)
        shard = None
        if self.sharded is not None and self.sharded._shard_counts is not None:
            sc = self.sharded._shard_counts
            shard = sc.reshape(sc.shape[0], -1).index_select(1, pixel.to(sc.device)).to(pixel.device)
        return sums, counts, shard

    def total_samples(self) -> torch.Tensor:
        return self.renderer.film.counts.sum()

    # -- frame mixes ----------------------------------------------------------

    def frame(self, camera) -> tuple:
        """One viewer frame: move the camera, step_freerun of the mix's
        iterations, the tonemapped film to the host. Returns (image, the
        seconds from the step's return to the image on the host)."""
        from rsoderh_raytracing_tpu_torch.scene.camera import Camera

        pos, yaw, pitch = camera
        self.renderer.camera = Camera(pos=pos, yaw=yaw, pitch=pitch, fov_y=self.camera0.fov_y)
        self.renderer.step_freerun(self.iterations)
        mid = time.perf_counter()
        image = self.renderer.film.tonemapped()
        return image, time.perf_counter() - mid

    # -- the traced run -------------------------------------------------------

    @contextlib.contextmanager
    def capture(self, iteration: int, store: dict, annotate):
        """Within the block, the first Wavefront step numbered `iteration`
        copies its loop state into store["carry"] (with the scene it
        walks) and runs inside annotate("portbench.capture")."""
        from rsoderh_raytracing_tpu_torch.render import wavefront

        original = wavefront.Wavefront.step

        def step(wave, it, *a, **k):
            if it != iteration or "carry" in store:
                return original(wave, it, *a, **k)
            store["carry"] = {key: v.clone() for key, v in wave.carry.items()}
            store["bvh"] = wave.scene.bvh
            with annotate("portbench.capture"):
                return original(wave, it, *a, **k)

        wavefront.Wavefront.step = step
        try:
            yield
        finally:
            wavefront.Wavefront.step = original

    def close(self):
        self.renderer = self.sharded = self.target = None

