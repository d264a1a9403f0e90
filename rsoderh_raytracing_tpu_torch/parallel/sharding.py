"""Multi-device rendering: a tile x sample split over a mesh of devices
(port of rsoderh_raytracing_tpu/parallel/sharding.py).

The reference runs one program over a ``jax.sharding.Mesh`` with
``shard_map`` and reduces the sample axis with ``psum``. The port is a
single controller: one process drives every slot of a (tile, sample) grid
of torch devices.

- ``tile``: image rows split across slots (rays are independent, so there
  are no halos);
- ``sample``: the slots of a tile render other progressive samples of the
  same pixels; their images are summed in slot order (s = 0 .. S-1) on the
  mesh's first device, the port's psum.

Lanes are seeded by (global pixel index, global sample index), so a
sharded render is the unsharded render of the same samples. The scene is
built once and copied once to each distinct device of the mesh
(``DeviceScene.to``). A slot may repeat a device where the caller lists
the devices: the CPU tests run eight slots on the CPU, and the card tests
(tests/test_torch_cuda.py) two or four on one card.

Every slot's tensors and launches run under ``torch.cuda.device(slot)``:
a kernel launch goes to the current device's stream, and the BVH walk
sizes its grid by the current device. Free-run slots advance iteration by
iteration across the slots, so the host enqueues every card's work before
it waits on any; one host sync ends a call.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rsoderh_raytracing_tpu_torch import _device, tracing
from rsoderh_raytracing_tpu_torch.ops import rng
from rsoderh_raytracing_tpu_torch.render.integrator import (
    MAX_BOUNCES,
    camera_pytree,
    generate_camera_rays,
    trace_rays,
)
from rsoderh_raytracing_tpu_torch.render.renderer import host_stats
from rsoderh_raytracing_tpu_torch.render.wavefront import (
    NO_LIMIT,
    Wavefront,
    check_drained,
    u32_tensor,
)


class Mesh:
    """A (tile, sample) grid of torch devices: ``grid[t][s]`` is slot
    (t, s); ``shape`` is {"tile": T, "sample": S}."""

    def __init__(self, grid):
        self.grid = [list(row) for row in grid]
        self.shape = {"tile": len(self.grid), "sample": len(self.grid[0])}

    @property
    def first(self) -> torch.device:
        """Where the sharded functions return their results."""
        return self.grid[0][0]

    def distinct(self) -> list:
        """The mesh's devices, each once, in slot order."""
        return list(dict.fromkeys(d for row in self.grid for d in row))


def _slot_device(device) -> torch.device:
    dev = _device.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int | None = None, tile: int | None = None, devices=None) -> Mesh:
    """Build a (tile, sample) mesh.

    With no arguments uses every CUDA device on one sample axis (pure
    sample-parallel: nothing crosses between cards until the final sum),
    and raises without a card. `devices` lists the slots' devices
    explicitly; only then may a device fill more than one slot."""
    if devices is None:
        _device.resolve("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [_slot_device(d) for d in devices]
    if n_devices is not None:
        if n_devices < 1:
            raise ValueError(f"requested {n_devices} devices")
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices but only {len(devices)} are available"
            )
        devices = devices[:n_devices]
    n = len(devices)
    tile = 1 if tile is None else tile
    if tile < 1 or n % tile != 0:
        raise ValueError(f"tile={tile} does not divide device count {n}")
    per_tile = n // tile
    return Mesh([devices[t * per_tile:(t + 1) * per_tile] for t in range(tile)])


class Replicas(dict):
    """{device: the object on that device}, one entry a distinct device of
    a mesh (``replicate``)."""


def replicate(obj, mesh: Mesh) -> Replicas:
    """`obj` (a DeviceScene, a DeviceEnvironment or a camera dict) on each
    distinct device of `mesh`: obj itself where it lies there already, a
    copy elsewhere. Replicas pass through, so a caller that renders many
    times copies once."""
    if isinstance(obj, Replicas):
        return obj
    out = Replicas()
    for dev in mesh.distinct():
        if isinstance(obj, dict):  # the camera
            out[dev] = {k: v.to(dev) for k, v in obj.items()}
        else:
            out[dev] = obj if obj.device == dev else obj.to(dev)
    return out


def _on(slot: torch.device):
    """The slot's CUDA device as the current one (a no-op context for a
    CPU slot)."""
    return torch.cuda.device(slot if slot.type == "cuda" else -1)


def _rows_of(height: int, mesh: Mesh) -> int:
    tile_n = mesh.shape["tile"]
    if height % tile_n != 0:
        raise ValueError(f"height {height} not divisible by tile={tile_n}")
    return height // tile_n


def _sample_rows(scene, env, camera, sample, resolution, row0, rows, max_bounces):
    """One sample of rows [row0, row0 + rows) through the scan integrator:
    (rows, W, 3) radiance."""
    width, _ = resolution
    lane = torch.arange(width * rows, device=scene.device, dtype=torch.int64)
    xs = lane % width
    ys = row0 + lane // width
    state = rng.seed(ys * width + xs, sample)
    state, ro, rd = generate_camera_rays(
        state, xs.to(torch.int32), ys.to(torch.int32), camera, resolution
    )
    _, light = trace_rays(scene, env, state, ro, rd, max_bounces)
    return torch.stack(light, dim=-1).reshape(rows, width, 3)


def render_spp_sharded(
    scene, env, camera, base_sample, mesh: Mesh, resolution, max_bounces: int = MAX_BOUNCES,
):
    """One sharded render step through the scan integrator (CLOSEST and
    ANY on the card): slot (t, s) renders rows [t*H/T, (t+1)*H/T) of
    progressive sample base_sample + s. Returns the SUM of the S samples
    as a full (H, W, 3) tensor on the mesh's first device (add it to the
    film with weight S). Height must be divisible by the tile axis size.
    scene, env and camera may be Replicas."""
    width, height = resolution
    rows = _rows_of(height, mesh)
    scenes, envs, cams = (replicate(x, mesh) for x in (scene, env, camera))
    first = mesh.first
    tiles = []
    for t, row in enumerate(mesh.grid):
        acc = None
        for s, slot in enumerate(row):
            with _on(slot):
                img = _sample_rows(scenes[slot], envs[slot], cams[slot],
                                   (int(base_sample) + s) & rng.MASK, resolution,
                                   t * rows, rows, max_bounces)
            img = img.to(first)
            acc = img if acc is None else acc + img
        tiles.append(acc)
    return torch.cat(tiles, dim=0)


def render_freerun_sharded(
    scene, env, camera, base_counts, mesh: Mesh, resolution, iterations,
    max_bounces: int = MAX_BOUNCES, with_stats: bool = False, compact_every: int | None = None,
):
    """Free-run wavefront across the mesh.

    Pixel rows split over `tile`; the `sample` axis splits each pixel's
    progressive sample STREAM by striding: slot s of S works samples s,
    s+S, s+2S, ... (render/wavefront.Wavefront with sample_stride=S,
    sample_offset=s): disjoint deterministic streams with no coordination.
    Returns (summed (H,W,3), counts (H,W), shard_counts (S,H,W)), int64
    counts on the mesh's first device: the radiance sum and TOTAL new
    samples this call, plus every slot's cumulative LOCAL stream position,
    the exact state to pass back as `base_counts` on the next call; with
    `with_stats` also the rays summed over the slots and the most
    iterations a slot ran.

    base_counts: either (S, H, W) per-shard local counts (the
    `shard_counts` from the previous call: exact resume), or (H, W)
    TOTAL per-pixel samples completed so far (or a scalar). Totals are
    only valid when the completed set is a PREFIX of every pixel's global
    stream (fresh start, exact-spp accumulation, or an UNSHARDED freerun);
    the ceil-division split below is exact for prefixes. A previous
    SHARDED freerun completes non-prefix sets (slots finish unequal
    counts per pixel), so resuming one from totals would re-render some
    sample indices and skip others: always feed its shard_counts back
    instead. scene, env and camera may be Replicas. Each slot's
    Wavefront lays out and compacts its own row block's lanes
    (compact_every as in render/wavefront.Wavefront).
    """
    width, height = resolution
    rows = _rows_of(height, mesh)
    s_n = mesh.shape["sample"]
    first = mesh.first
    scenes, envs, cams = (replicate(x, mesh) for x in (scene, env, camera))
    base = u32_tensor(base_counts, first)
    per_shard = base.dim() == 3
    if per_shard:
        if tuple(base.shape) != (s_n, height, width):
            raise ValueError(f"per-shard base counts {tuple(base.shape)} for a "
                             f"{s_n}-wide sample axis at {width}x{height}")
    elif base.numel() == 1:
        base = base.reshape(1, 1).expand(height, width)
    else:
        base = base.reshape(height, width)

    slots = []
    for t, row in enumerate(mesh.grid):
        block = slice(t * rows, (t + 1) * rows)
        for s, slot in enumerate(row):
            if per_shard:
                local = base[s, block]
            else:
                # Prefix-complete totals: this slot owns global sample
                # indices k*S + s, so its next local index is
                # ceil((base - s) / S), in u32.
                local = ((base[block] + (s_n - 1 - s)) & rng.MASK) // s_n
            with _on(slot):
                wave = Wavefront(
                    scenes[slot], envs[slot], cams[slot], local.to(slot), resolution,
                    NO_LIMIT, iterations, max_bounces,
                    row0=t * rows, rows=rows, sample_stride=s_n, sample_offset=s,
                    compact_every=compact_every,
                )
            slots.append((t, s, slot, local, wave))

    for it in range(slots[0][-1].drain_iterations()):
        for _, _, slot, _, wave in slots:
            with _on(slot):
                wave.step(it)
    flags = []
    for _, _, slot, _, wave in slots:
        with _on(slot):
            flags.append(wave.in_path())
    check_drained(flags)

    summed, counts = [None] * len(mesh.grid), [None] * len(mesh.grid)
    shard_counts = torch.empty((s_n, height, width), dtype=torch.int64, device=first)
    zero = torch.zeros((), dtype=torch.int64, device=first)
    stats = {"closest_rays": zero, "shadow_rays": zero, "iterations": zero, "fallback_lanes": zero}
    for t, s, slot, local, wave in slots:
        with _on(slot):
            film, cnt, st = wave.results()
        film = film.reshape(rows, width, 3).to(first)
        cnt = cnt.reshape(rows, width).to(first)
        summed[t] = film if s == 0 else summed[t] + film
        counts[t] = cnt if s == 0 else counts[t] + cnt
        shard_counts[s, t * rows:(t + 1) * rows] = (local + cnt) & rng.MASK
        stats["closest_rays"] = stats["closest_rays"] + st["closest_rays"].to(first)
        stats["shadow_rays"] = stats["shadow_rays"] + st["shadow_rays"].to(first)
        stats["fallback_lanes"] = stats["fallback_lanes"] + st["fallback_lanes"].to(first)
        stats["iterations"] = torch.maximum(stats["iterations"], st["iterations"].to(first))
    out = (torch.cat(summed, dim=0), torch.cat(counts, dim=0), shard_counts)
    return (*out, stats) if with_stats else out


class ShardedRenderer:
    """Wraps a Renderer to run its steps across a device mesh.

    Each .step() renders S samples (S = sample-axis size) and adds them
    to the film in one go. Free-run steps carry per-shard stream
    positions (`_shard_counts`) between calls so every slot resumes its
    own strided sample stream exactly (see render_freerun_sharded's prefix
    discussion). The scene is copied to the mesh's devices once, each
    environment once when first used."""

    def __init__(self, renderer, mesh: Mesh):
        self.inner = renderer
        self.mesh = mesh
        self._shard_counts = None  # (S, H, W) int64 after a free-run step
        self._scenes = replicate(renderer.device_scene, mesh)
        self._envs: dict[int, Replicas] = {}
        self.last_stats = None

    @staticmethod
    def wrap(renderer, spec: str) -> "ShardedRenderer":
        """spec: 'dp:N' (sample-parallel over N devices) or 'tile:T,dp:S'
        (T x S mesh). A renderer on the CPU gets slots on the CPU; one on
        CUDA gets that many distinct cards (dp defaults to every card)."""
        on_cpu = renderer.device.type == "cpu"
        try:
            parts = dict(p.split(":", 1) for p in spec.replace(" ", "").split(","))
            if not set(parts) <= {"dp", "tile"}:
                raise ValueError(spec)
            n = int(parts.get("dp", 1 if on_cpu else torch.cuda.device_count()))
            tile = int(parts.get("tile", 1))
        except (ValueError, TypeError) as exc:
            raise ValueError(
                f"bad --devices spec '{spec}': expected 'dp:N' or 'tile:T,dp:S'"
            ) from exc
        devices = [renderer.device] * (tile * n) if on_cpu else None
        return ShardedRenderer(renderer, make_mesh(n_devices=tile * n, tile=tile, devices=devices))

    # Renderer API surface -------------------------------------------------
    @property
    def film(self):
        return self.inner.film

    @property
    def camera(self):
        return self.inner.camera

    def save_png(self, path) -> None:
        self.inner.save_png(path)

    def save_hdr(self, path) -> None:
        self.inner.save_hdr(path)

    def save_checkpoint(self, path) -> None:
        """Film checkpoint plus this mesh's per-shard stream positions
        (uint32, the reference's layout): a sharded freerun completes a
        NON-prefix global sample set, so resuming it exactly needs the
        per-slot counts, not the film's totals."""
        extra = {"state_stamp": self.inner._state_stamp()}
        if self._shard_counts is not None:
            extra["shard_counts"] = self._shard_counts.cpu().numpy().astype(np.uint32)
        self.inner.film.save_checkpoint(path, **extra)

    def load_checkpoint(self, path) -> None:
        """Load a checkpoint (the state stamp checked as Renderer does);
        refuses per-shard counts of another sample-axis width."""
        self.inner._check_state_stamp(path)
        with np.load(path) as z:
            sc = z["shard_counts"] if "shard_counts" in z.files else None
        s = self.mesh.shape["sample"]
        if sc is not None and sc.shape[0] != s:
            raise ValueError(
                f"checkpoint was produced on a {sc.shape[0]}-wide sample axis but this"
                f" mesh has {s}: the completed sample set cannot be re-split exactly;"
                " resume with the original mesh shape"
            )
        self.inner.film.load_checkpoint(path)
        # Without shard_counts the checkpoint is a totals-only one (fresh,
        # exact or unsharded freerun): prefix-complete, so the split of
        # the totals is exact.
        self._shard_counts = None if sc is None else u32_tensor(sc, self.mesh.first)

    def _reset_if_changed(self) -> None:
        inner = self.inner
        state_hash = inner._state_hash()
        if state_hash != inner._last_state_hash:
            with tracing.span("renderer.reset"):
                inner.film.reset()
            self._shard_counts = None
            inner._last_state_hash = state_hash

    def _env(self) -> Replicas:
        idx = self.inner.environment_index
        if idx not in self._envs:
            self._envs[idx] = replicate(self.inner._device_env(), self.mesh)
        return self._envs[idx]

    def _camera(self) -> Replicas:
        return replicate(camera_pytree(self.inner.camera, self.mesh.first), self.mesh)

    def step(self) -> int:
        """S samples a pixel through the scan integrator; returns the
        sample count."""
        inner = self.inner
        self._reset_if_changed()
        summed = render_spp_sharded(
            self._scenes, self._env(), self._camera(), inner.film.sample_count, self.mesh,
            (inner.width, inner.height), inner.max_bounces,
        )
        inner.film.add_samples(summed.to(inner.film.device), self.mesh.shape["sample"])
        return inner.film.sample_count

    @tracing.traced("renderer.step_freerun")
    def step_freerun(self, iterations: int, compact_every: int | None = None) -> int:
        """Sharded free-run step (render_freerun_sharded); returns the
        minimum per-pixel sample count, ``last_stats`` the rays traced.
        Traced as the root span of a call, each slot's wavefront.step
        tagged with its slot."""
        inner = self.inner
        self._reset_if_changed()
        # Per-shard stream positions when we have them (exact resume);
        # otherwise the film's totals, valid as a prefix split.
        base = self._shard_counts if self._shard_counts is not None else inner.film.counts
        summed, counts, shard_counts, stats = render_freerun_sharded(
            self._scenes, self._env(), self._camera(), base, self.mesh,
            (inner.width, inner.height), iterations, inner.max_bounces, with_stats=True,
            compact_every=compact_every,
        )
        self._shard_counts = shard_counts
        inner.film.add_freerun(summed.to(inner.film.device), counts.to(inner.film.device))
        self.last_stats = host_stats(stats)
        return inner.film.sample_count

    def render(self, spp: int = 16, progress: bool = False, batch: int | None = None,
               mode: str = "exact") -> np.ndarray:
        """Render until every pixel has >= `spp` samples (the TOTAL
        target); returns the tonemapped image. mode="exact" steps S samples
        at a time (`batch` is the Renderer's argument and has no effect
        here); mode="freerun" loops sharded free-run steps."""
        del batch
        start = time.perf_counter()
        if mode == "freerun":
            while self.film.sample_count < spp:
                remaining = spp - self.film.sample_count
                self.step_freerun(max(16, remaining * 4))
                if progress:
                    done = self.film.sample_count
                    elapsed = time.perf_counter() - start
                    print(f"  min spp {done}/{spp}  ({done / max(elapsed, 1e-9):.2f} spp/s)")
            return self.film.tonemapped()
        if mode != "exact":
            raise ValueError(f"unknown mode '{mode}'")
        if self.film.sample_count and not self.film.is_uniform:
            raise ValueError(
                "exact mode cannot extend a non-uniform (free-run)"
                " accumulation: sample indices above the per-pixel"
                " minimum would be re-rendered. Use mode='freerun'."
            )
        s = self.mesh.shape["sample"]
        base = self.film.sample_count
        steps = max(0, -(-(spp - base) // s))
        for i in range(steps):
            self.step()
            if progress:
                elapsed = time.perf_counter() - start
                done = base + (i + 1) * s
                print(f"  sample {done}/{base + steps * s}"
                      f"  ({(done - base) / max(elapsed, 1e-9):.2f} spp/s)")
        return self.film.tonemapped()


def dryrun(n_devices: int, device=_device.DEFAULT) -> None:
    """Run both sharded functions over an n_devices mesh of slots on one
    `device`, on tiny shapes (the counterpart of the reference's
    __graft_entry__.dryrun_multichip): house, procedural_sky(256, 128),
    4 bounces; a (2, n/2) mesh when n is even and at least 4. Asserts the
    shapes, finite pixels and that every pixel completed at least S
    samples; prints one line."""
    import os

    from rsoderh_raytracing_tpu_torch.env.environment import Environment, device_environment
    from rsoderh_raytracing_tpu_torch.env.hdr_io import procedural_sky
    from rsoderh_raytracing_tpu_torch.scene.device import build_device_scene
    from rsoderh_raytracing_tpu_torch.scene.toml_loader import load_scene

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    scene = load_scene(os.path.join(root, "assets", "scenes", "house.toml"))
    dev = _slot_device(device)
    ds = build_device_scene(scene, dev)
    env = device_environment(Environment.from_texture("bench_sky", procedural_sky(256, 128)), dev)
    cam = camera_pytree(scene.camera, dev)

    tile = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(n_devices=n_devices, tile=tile, devices=[dev] * n_devices)
    height = 16 * mesh.shape["tile"]
    out = render_spp_sharded(ds, env, cam, 0, mesh, (32, height), 4)
    if tuple(out.shape) != (height, 32, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"render_spp_sharded: shape {tuple(out.shape)} or non-finite pixels")
    img, counts, _ = render_freerun_sharded(ds, env, cam, np.zeros((height, 32), np.uint32), mesh,
                                            (32, height), 4, 4)
    if tuple(img.shape) != (height, 32, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"render_freerun_sharded: shape {tuple(img.shape)} or non-finite pixels")
    if int(counts.min()) < mesh.shape["sample"]:
        raise AssertionError(f"render_freerun_sharded: a pixel completed {int(counts.min())} samples")
    print(f"dryrun ok: mesh={mesh.shape} device={dev} out={tuple(out.shape)}"
          f" freerun_min_spp={int(counts.min())}")
