"""msamples_per_s: pixel samples that the window's calls completed (the
film's per-pixel counts, summed, at the end of the last call less at the
window's start), over the seconds from the window's start to the end of
its last call, in millions."""

from portbench import stats


def read(run):
    if run["kind"] != "render":
        return None
    start, end = run["window"]
    return stats.rate(run["samples"], start, end) / 1e6
