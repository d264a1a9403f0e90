"""roofline_pct.trace: on one captured steady iteration of a small-route
render call, TRACE's least time (portbench/counts.py: the valid rows
swept for the live lanes, over the H100's published peaks) over its
device time, in percent."""


def read(run):
    cap = (run["capture"] or {}).get("trace")
    if not cap or cap["seconds"] <= 0:
        return None
    return 100.0 * cap["least"] / cap["seconds"]
