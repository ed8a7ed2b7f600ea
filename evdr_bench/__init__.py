"""The benchmark of evdr_tpu_torch on one NVIDIA H100.

``python3 evdr_bench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
result line. Configurations (``configs/``), traffic mixes (``traffic/``) and
per-layer metric readers (``metrics/``) are files found by the names in
``BENCHMARK.json``; a traffic mix names the driver (``drivers/``) that
plays it. Nothing here imports JAX or the JAX package.
"""
