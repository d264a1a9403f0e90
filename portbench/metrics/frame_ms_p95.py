"""frame_ms_p95: the nearest-rank 95th percentile of every frame of the
window, each from the camera move to the tonemapped image on the host, in
milliseconds."""

from portbench import stats


def read(run):
    if run["kind"] != "frame" or not run["frames"]:
        return None
    return stats.percentile([(f["end"] - f["start"]) * 1e3 for f in run["frames"]], 95)
