"""The benchmark of ``oak_tpu_torch`` on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line (README.md).
Nothing here imports ``jax`` or ``oak_tpu``; ``benchmark.reference`` imports
no module of ``oak_tpu_torch`` either.
"""
