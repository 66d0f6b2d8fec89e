"""The benchmark of panmap_tpu_torch on NVIDIA cards (BENCHMARK.json)."""
