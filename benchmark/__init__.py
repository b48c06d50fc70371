"""Benchmark of flashfry_tpu_torch: `discover` jobs through the port's CLI.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once and prints one JSON
line. Configurations, traffic mixes and per-layer metrics are files found
by name: `configs/<config>.json`, `traffic/<mix>.json` and
`metrics/<metric>.py`. Nothing here imports JAX or the JAX package; only
`harness.py` and `run.py` import the port, and the reference
(`reference.py`) imports nothing of it.
"""
