"""How `correct` is decided: the answers the timed path produced, read
back after the window, against the plain reference (portbench/reference)
on the same inputs.

A render answer is one (call, pixel): the samples the call completed for
the pixel on each card (from each slot's stream position before and after
the call) and the radiance the call added to the film. The reference
traces the pixel's paths from the same stream positions under the same
iteration budget: a slot starts local sample k (global sample
(base + k) * stride + offset) while the segments of the samples before it
sum to less than the budget, and every started sample completes. Its
count must equal the program's, and the sum of its radiances (slot by
slot, in sample order) must lie within SUM_RTOL of it, plus the float32
rounding of the film's subtraction (FILM_ULPS ulps of the accumulated
value) and SUM_ATOL a sample. The film's own count of the pixel, whose
sum over the pixels is the numerator of the rate, must have grown by the
reference's counts summed over the cards.

A frame answer is one (frame, pixel) of the tonemapped image the host
received: the reference renders the pixel's samples from 0 under the
frame's camera and budget, takes the mean and the ACES tonemap, and must
lie within FRAME_RTOL of it, plus FRAME_ATOL.

The numbers compared are the percentages of answers that miss; each has
the limit that the cell's mix states, set from the readings in PERF.md.
"""

from __future__ import annotations

import torch

from portbench.reference import rng
from portbench.reference.integrator import trace_paths

SUM_RTOL = 1e-3
SUM_ATOL = 1e-4
FILM_ULPS = 4.0
FRAME_RTOL = 1e-3
FRAME_ATOL = 1e-4

_M1 = ((0.59719, 0.35458, 0.04823), (0.07600, 0.90834, 0.01566), (0.02840, 0.13383, 0.83777))
_M2 = ((1.60475, -0.53108, -0.07367), (-0.10208, 1.10813, -0.00605), (-0.00327, -0.07276, 1.07602))


def aces(hdr: torch.Tensor) -> torch.Tensor:
    """(n, 3) linear radiance -> ACES-fitted display values in [0, 1];
    a negative pixel is magenta."""
    m1 = torch.tensor(_M1, dtype=hdr.dtype, device=hdr.device)
    m2 = torch.tensor(_M2, dtype=hdr.dtype, device=hdr.device)
    v = hdr @ m1.T
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    mapped = torch.clamp((a / b) @ m2.T, 0.0, 1.0)
    magenta = torch.tensor([1.0, 0.0, 1.0], dtype=hdr.dtype, device=hdr.device)
    return torch.where((hdr < 0.0).any(dim=-1, keepdim=True), magenta, mapped)


def freerun(ref, cam, pixel, base, limit, stride, offset, budget, bf16=False):
    """(counts (m,), sums (m, 3)) that a free-run lane of each pixel
    completes from local sample `base` under `budget` iterations,
    tracing at most limit[i] + 1 samples of lane i (enough to tell
    whether it completes limit[i])."""
    dev = pixel.device
    m = pixel.shape[0]
    k_max = int(limit.max()) + 1 if m else 1
    k = torch.arange(k_max, device=dev)
    take = k[None, :] <= limit[:, None]
    lane, kk = torch.nonzero(take, as_tuple=True)
    glob = ((base[lane] + kk) * stride + offset) & rng.MASK
    rad = torch.zeros((m, k_max, 3), device=dev)
    seg = torch.full((m, k_max), budget + 1, dtype=torch.int64, device=dev)
    step = 1 << 16
    for s in range(0, lane.shape[0], step):
        sl = slice(s, s + step)
        r, g = trace_paths(ref["scene"], ref["env"], cam, pixel[lane[sl]], glob[sl], ref["width"],
                           ref["height"], ref["max_bounces"], ref["formulas"], bf16)
        rad[lane[sl], kk[sl]] = r
        seg[lane[sl], kk[sl]] = g
    before = torch.cumsum(seg, dim=1) - seg  # iterations before sample k starts
    started = before < budget
    counts = started.to(torch.int64).cumprod(dim=1).sum(dim=1)
    sums = torch.zeros((m, 3), device=dev)
    for j in range(k_max):
        sums = sums + torch.where((j < counts)[:, None], rad[:, j], 0.0)
    return counts, sums


def render_answers(ref, cam, answers, budget, bf16=False):
    """Reference (counts (S, P), sums (P, 3)) of each checked call.
    answers: dicts with pixel (P,), base (S, P) local stream positions,
    counts (S, P) the program's completed samples on each card."""
    out = []
    for a in answers:
        slots = a["base"].shape[0]
        counts, total = [], None
        for s in range(slots):
            c, sums = freerun(ref, cam, a["pixel"], a["base"][s], a["counts"][s].clamp(0, budget), slots, s,
                              budget, bf16)
            counts.append(c)
            total = sums if total is None else total + sums
        out.append((torch.stack(counts), total))
    return out


def compare_render(answers, refs):
    """(count_wrong_pct, sum_wrong_pct) over every checked (call, pixel):
    a count is wrong where a card's count or the film's differs from the
    reference's."""
    n = wrong_count = wrong_sum = 0
    for a, (ref_counts, ref_sums) in zip(answers, refs):
        count_ok = (ref_counts == a["counts"]).all(dim=0) & (ref_counts.sum(dim=0) == a["film_counts"])
        slack = (SUM_RTOL * ref_sums.abs() + SUM_ATOL * a["counts"].sum(dim=0)[:, None]
                 + FILM_ULPS * torch.finfo(torch.float32).eps * a["film_after"].abs())
        sum_ok = ((a["sums"] - ref_sums).abs() <= slack).all(dim=1)
        n += count_ok.shape[0]
        wrong_count += int((~count_ok).sum())
        wrong_sum += int((count_ok & ~sum_ok).sum())
    return 100.0 * wrong_count / max(n, 1), 100.0 * wrong_sum / max(n, 1)


def frame_answers(ref, frames, budget, bf16=False):
    """Reference tonemapped (P, 3) of each checked frame: dicts with pixel
    (P,) and camera."""
    out = []
    for f in frames:
        zero = torch.zeros_like(f["pixel"])
        counts, sums = freerun(ref, f["camera"], f["pixel"], zero, torch.full_like(zero, budget), 1, 0,
                               budget, bf16)
        out.append(aces(sums / torch.clamp_min(counts.to(torch.float32), 1.0)[:, None]))
    return out


def compare_frames(frames, refs):
    """pixel_wrong_pct over every checked (frame, pixel)."""
    n = wrong = 0
    for f, r in zip(frames, refs):
        ok = ((f["values"] - r).abs() <= FRAME_RTOL * r.abs() + FRAME_ATOL).all(dim=1)
        n += ok.shape[0]
        wrong += int((~ok).sum())
    return 100.0 * wrong / max(n, 1)
