"""The benchmark's own arithmetic: rates over a window, percentiles, the
device's busy and idle time from a profiler trace, kernel groups, and the
roofline's least time against the card's published peaks.

The trace arithmetic copies the port's profiling.kernel_breakdown (the
union of device intervals) and profiling._group (kernel groups); the
peaks are NVIDIA's data sheet for the H100 SXM at its full 700 W power
limit, so every roofline share is stated beside the card's limit.
"""

from __future__ import annotations

import collections
import math

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_PER_S = 67e12  # f32 outside the tensor cores
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The port's own CUDA kernels (csrc/*.cu) and their groups, in the order
# that a name is matched (big_shade_kernel before shade_kernel, the
# chunked kernels before closest_kernel and any_kernel).
OWN_KERNELS = (
    ("trace_kernel", "trace"), ("big_shade_kernel", "big_shade"), ("shade_kernel", "shade"),
    ("chunked_closest_kernel", "chunked_closest"), ("chunked_any_kernel", "chunked_any"),
    ("fused_kernel", "fused"), ("closest_kernel", "closest"), ("any_kernel", "any"),
)


def rate(count: float, start: float, end: float) -> float:
    """count over the whole window [start, end]."""
    return count / (end - start)


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of every value."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no values")
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def kernel_group(name: str) -> str:
    """The group of a device operation: one of the port's kernels (the BVH
    walks and BVH_CLOSEST's fallback pass as bvh_closest and bvh_any), or
    gather (index_select), or glue (every other PyTorch kernel)."""
    if "fallback_kernel" in name:
        return "bvh_closest"
    if "walk_kernel" in name:
        return "bvh_closest" if "Closest" in name else "bvh_any"
    for kernel, group in OWN_KERNELS:
        if kernel in name:
            return group
    if "gather" in name or "indexselect" in name.lower():
        return "gather"
    return "glue"


def is_own_kernel(name: str) -> bool:
    return kernel_group(name) not in ("gather", "glue")


def union_length(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_busy(ops, window, devices):
    """{device: seconds some operation ran} within window (start, end),
    from ops [(name, device, start, end)] in seconds."""
    lo, hi = window
    by_dev = collections.defaultdict(list)
    for _, dev, s, e in ops:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            by_dev[dev].append((s, e))
    return {d: union_length(by_dev.get(d, [])) for d in devices}


def idle_pct(ops, window, devices) -> float:
    """The highest share, over `devices`, of the window in which the device
    ran nothing, in percent."""
    busy = device_busy(ops, window, devices)
    length = window[1] - window[0]
    return max(100.0 * (1.0 - b / length) for b in busy.values())


def idle_gaps(ops, host_ops, window, device, top=10):
    """The longest stretches in which `device` ran nothing (the 2,000
    longest gaps), summed by the innermost host operation (name, start,
    end) running at each gap's start ("host" where none): [(name,
    seconds)], longest first."""
    lo, hi = window
    spans = sorted((max(s, lo), min(e, hi)) for _, d, s, e in ops if d == device and e > lo and s < hi)
    gaps, cursor = [], lo
    for s, e in spans:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        gaps.append((cursor, hi))
    by_name = collections.Counter()
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
        inner = [(s, e, n) for n, s, e in host_ops if s <= g0 < e]
        name = min(inner, key=lambda x: x[1] - x[0])[2] if inner else "host"
        by_name[name] += g1 - g0
    return [[n, v] for n, v in by_name.most_common(top)]


def least_seconds(n_bytes: float, n_ops: float):
    """(least seconds, "bytes" or "operations"): the larger of the bytes
    over the memory rate and the operations over the f32 rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
