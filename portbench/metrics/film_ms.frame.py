"""film_ms.frame: the benchmark's span from step_freerun's return to the
tonemapped image on the host, the mean over the window's frames, in
milliseconds."""


def read(run):
    if run["kind"] != "frame" or not run["frames"]:
        return None
    return 1e3 * sum(f["film_s"] for f in run["frames"]) / len(run["frames"])
