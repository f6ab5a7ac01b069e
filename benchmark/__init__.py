"""The benchmark of raytrace_tpu_torch on an NVIDIA H100: one cell a run,
found by name in BENCHMARK.json (see benchmark/run.py)."""
