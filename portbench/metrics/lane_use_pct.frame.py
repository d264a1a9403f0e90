"""lane_use_pct.frame: as lane_use_pct.render, over the window's
frames."""


def read(run):
    if run["kind"] != "frame" or not run["frames"]:
        return None
    rays = sum(f["closest_rays"] for f in run["frames"])
    return 100.0 * rays / (run["lanes"] * run["iterations_launched"] * len(run["frames"]))
