"""idle_pct.frame: in a frame cell's traced frames, the share of the
profiled window in which the card runs no kernel, memset or copy, in
percent."""

from portbench import stats


def read(run):
    if run["kind"] != "frame" or run["trace"] is None:
        return None
    t = run["trace"]
    return stats.idle_pct(t["ops"], t["window"], range(run["cards"]))
