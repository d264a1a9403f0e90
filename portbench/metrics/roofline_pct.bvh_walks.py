"""roofline_pct.bvh_walks: on one captured steady iteration of a BVH-route
render call, the summed least time of BVH_CLOSEST and BVH_ANY
(portbench/counts.py: the node visits, box and leaf tests of a walk of
the program's tree over those rays, over the H100's published peaks) over
their summed device time, in percent."""


def read(run):
    cap = (run["capture"] or {}).get("bvh_walks")
    if not cap or cap["seconds"] <= 0:
        return None
    return 100.0 * cap["least"] / cap["seconds"]
