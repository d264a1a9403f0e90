"""The benchmark of the PyTorch and CUDA port (rsoderh_raytracing_tpu_torch):
``python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of BENCHMARK.json once (portbench/run.py)."""
