"""Interactive terminal viewer (port of rsoderh_raytracing_tpu/viewer)."""
