"""frames_per_s: frames completed in the window over the window's
seconds."""

from portbench import stats


def read(run):
    if run["kind"] != "frame" or not run["frames"]:
        return None
    start, end = run["window"]
    return stats.rate(len(run["frames"]), start, end)
