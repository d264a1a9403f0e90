"""setup_s: seconds from the start of the process to the start of the
measured window (imports, scene files, the port's scene, environment and
Renderer, the resume, one warm-up call or frame with its kernel build or
load)."""


def read(run):
    return run["setup_s"]
