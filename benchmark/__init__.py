"""The benchmark of ibgs_tpu_torch on one H100 (see BENCHMARK.json and
PERF.md): `python3 -m benchmark.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`."""
