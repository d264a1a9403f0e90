"""scene_build_s: the benchmark's span around the environment's alias
table and the Renderer's construction (device scene, BVH build), in
seconds."""


def read(run):
    return run["scene_build_s"]
