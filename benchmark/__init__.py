"""The benchmark of dpc_tpu_torch: see BENCHMARK.json and PERF.md."""
