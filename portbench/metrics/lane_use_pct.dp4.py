"""lane_use_pct.dp4: lane_use_pct.render of the four-card cell, over
every card's lanes, which moves msamples_per_s.dp4."""

from portbench import spec


def read(run):
    return spec.reader("lane_use_pct.render")(run)
