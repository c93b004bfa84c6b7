"""The benchmark of trico_tpu_torch: see BENCHMARK.json and PERF.md."""
