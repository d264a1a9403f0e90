"""lane_use_pct.render: the lanes that traced a ray (closest_rays, summed
over the window's calls) over the lanes times the iterations each call
launched (budget + max_bounces - 1; the rest is the drain's idle lanes),
in percent."""


def read(run):
    if run["kind"] != "render" or not run["calls"]:
        return None
    rays = sum(c["closest_rays"] for c in run["calls"])
    return 100.0 * rays / (run["lanes"] * run["iterations_launched"] * len(run["calls"]))
