"""glue_ms_per_iter.render: in a render cell's traced call, the device
milliseconds per launched iteration of every operation that is not one of
the port's own CUDA kernels (PyTorch's elementwise, index, gather and
reduction kernels, copies and memsets), on the first card."""

from portbench import stats


def read(run):
    if run["kind"] != "render" or run["trace"] is None:
        return None
    t = run["trace"]
    lo, hi = t["window"]
    glue = sum(min(e, hi) - max(s, lo) for n, d, s, e in t["ops"]
               if d == t["devices"][0] and e > lo and s < hi and not stats.is_own_kernel(n))
    return glue * 1e3 / t["iterations"]
