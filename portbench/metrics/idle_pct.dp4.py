"""idle_pct.dp4: idle_pct.render of the four-card cell (the most idle
card), which moves msamples_per_s.dp4."""

from portbench import spec


def read(run):
    return spec.reader("idle_pct.render")(run)
