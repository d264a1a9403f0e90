"""Multi-device rendering (port of rsoderh_raytracing_tpu/parallel)."""
