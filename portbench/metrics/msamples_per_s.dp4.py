"""msamples_per_s.dp4: msamples_per_s of a cell whose film is rendered
across four cards. A metric of its own, with its own bound: one host
thread enqueuing four cards' iterations spreads far wider from run to
run than one card does."""

from portbench import spec


def read(run):
    return spec.reader("msamples_per_s")(run)
