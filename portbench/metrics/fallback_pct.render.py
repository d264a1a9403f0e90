"""fallback_pct.render: the closest rays that BVH_CLOSEST's walk left to
its fallback sweep of every sphere and plane row (the program's
fallback_lanes counter, summed over the window's calls) over the closest
rays traced, in percent. None where a call carries no such counter (a
program without it)."""


def read(run):
    calls = run["calls"]
    if run["kind"] != "render" or not calls or any("fallback_lanes" not in c for c in calls):
        return None
    rays = sum(c["closest_rays"] for c in calls)
    if rays <= 0:
        return None
    return 100.0 * sum(c["fallback_lanes"] for c in calls) / rays
