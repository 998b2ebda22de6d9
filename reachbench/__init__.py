"""reachbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 reachbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Configurations, traffic mixes and metrics are files of their own under
``configs/``, ``traffic/`` and ``metrics/``, found by the names that
``BENCHMARK.json`` gives them (README.md).
"""
