"""Progressive accumulation film and its display conversion (port of
rsoderh_raytracing_tpu/render/film.py).

The film holds, on its device, the (H, W, 3) float32 sums of sample
radiance and the (H, W) per-pixel sample counts. Counts are int64 tensors
holding u32 values (torch has no uint32 arithmetic on the CPU; the
wavefront returns int64 too); a checkpoint stores them as uint32, in the
reference's ``.npz`` layout (``cumulative``, ``counts``, ``sample_count``
and any extra arrays such as ``state_stamp``), so either package loads
the other's file.
"""

from __future__ import annotations

import numpy as np
import torch

from rsoderh_raytracing_tpu_torch import _device, tracing
from rsoderh_raytracing_tpu_torch.ops.tonemap import aces_tonemap, linear_to_srgb


def _display(cumulative, counts):
    mean = cumulative / torch.clamp_min(counts.to(torch.float32), 1.0)[..., None]
    return aces_tonemap(mean)


class Film:
    """Per-pixel radiance sums and per-pixel sample counts.

    Uniform accumulation keeps every count equal; the free-run wavefront
    adds a variable number of samples per pixel, which the mean handles.
    ``sample_count`` is the minimum count, what every pixel has reached.
    """

    def __init__(self, width: int, height: int, device=_device.DEFAULT):
        self.width = width
        self.height = height
        self.device = _device.resolve(device)
        self.reset()

    def reset(self) -> None:
        self.cumulative = torch.zeros(
            (self.height, self.width, 3), dtype=torch.float32, device=self.device)
        self.counts = torch.zeros((self.height, self.width), dtype=torch.int64, device=self.device)
        self._uniform_count: int | None = 0
        # The minimum of non-uniform counts: enqueued when the counts
        # change, read (one sync) at the first sample_count after that.
        self._min_dev = None
        self._min_cache: int | None = None

    def resize(self, width: int, height: int) -> None:
        self.width = width
        self.height = height
        self.reset()

    @property
    def sample_count(self) -> int:
        if self._uniform_count is not None:
            return self._uniform_count
        if self._min_cache is None:
            if self._min_dev is None:
                self._min_dev = self.counts.min()
            with tracing.span("film.min_count"):
                tracing.count("sync.min_count")
                self._min_cache = int(self._min_dev)
        return self._min_cache

    @property
    def is_uniform(self) -> bool:
        """True while every pixel holds the same sample count (no
        free-run accumulation since the last reset): what extending the
        film in exact mode requires."""
        return self._uniform_count is not None

    def add_sample(self, sample) -> None:
        """Add ONE uniform sample for every pixel."""
        self.add_samples(sample, 1)

    @tracing.traced("film.add")
    def add_samples(self, summed, count: int) -> None:
        """Add the SUM of `count` uniform samples per pixel."""
        self.cumulative = self.cumulative + summed
        self.counts = self.counts + int(count)
        if self._uniform_count is not None:
            self._uniform_count += int(count)
        else:
            self._min_dev = self.counts.min()
            self._min_cache = None

    @tracing.traced("film.add")
    def add_freerun(self, summed, counts) -> None:
        """Add a free-run result: per-pixel sums and per-pixel counts."""
        self.cumulative = self.cumulative + summed
        self.counts = self.counts + counts.to(torch.int64)
        self._uniform_count = None
        self._min_dev = self.counts.min()
        self._min_cache = None

    def mean_radiance(self) -> np.ndarray:
        counts = torch.clamp_min(self.counts.to(torch.float32), 1.0)[..., None]
        tracing.count("sync.readback")
        return (self.cumulative / counts).cpu().numpy()

    def tonemapped(self) -> np.ndarray:
        """ACES display image, linear [0, 1]: the spans film.tonemap and
        film.readback (a host sync on the card, sync.readback)."""
        with tracing.span("film.tonemap"):
            image = _display(self.cumulative, self.counts)
        with tracing.span("film.readback"):
            tracing.count("sync.readback")
            return image.cpu().numpy()

    def srgb8(self) -> np.ndarray:
        """8-bit sRGB image for PNG output."""
        srgb = linear_to_srgb(_display(self.cumulative, self.counts))
        tracing.count("sync.readback")
        return torch.clamp(srgb * 255.0 + 0.5, 0, 255).to(torch.uint8).cpu().numpy()

    def save_checkpoint(self, path: str, **extra) -> None:
        """Save the raw accumulation state; `extra` arrays (the
        renderer's state stamp) ride in the same .npz, and loaders ignore
        keys they do not know."""
        tracing.count("sync.checkpoint_save", 2)
        np.savez(
            path,
            cumulative=self.cumulative.cpu().numpy(),
            counts=self.counts.cpu().numpy().astype(np.uint32),
            sample_count=self.sample_count,
            **extra,
        )

    @tracing.traced("film.load_checkpoint")
    def load_checkpoint(self, path: str) -> None:
        """Load a checkpoint: two uploads, host syncs on the card
        (sync.checkpoint_load)."""
        tracing.count("sync.checkpoint_load", 2)
        with np.load(path) as z:
            cumulative = z["cumulative"]
            if cumulative.shape != (self.height, self.width, 3):
                raise ValueError(
                    f"checkpoint shape {cumulative.shape} != film"
                    f" ({self.height}, {self.width}, 3)"
                )
            self.cumulative = torch.from_numpy(cumulative.astype(np.float32)).to(self.device)
            self._min_dev = None
            self._min_cache = None
            if "counts" in z.files:
                counts = z["counts"].astype(np.uint32)
                self._uniform_count = (
                    int(z["sample_count"]) if np.unique(counts).size == 1 else None
                )
            else:  # scalar-count checkpoints of the first format
                self._uniform_count = int(z["sample_count"])
                counts = np.full((self.height, self.width), self._uniform_count, np.uint32)
            self.counts = torch.from_numpy(counts.astype(np.int64)).to(self.device)
