"""idle_pct.render: in a render cell's traced call, the share of the
profiled window in which a card runs no kernel, memset or copy, the
highest over the cell's cards, in percent."""

from portbench import stats


def read(run):
    if run["kind"] != "render" or run["trace"] is None:
        return None
    t = run["trace"]
    return stats.idle_pct(t["ops"], t["window"], range(run["cards"]))
