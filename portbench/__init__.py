"""The benchmark of ``levelsetfusion_tpu_torch`` on NVIDIA GPUs.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. The
cells, configurations, traffic mixes, entry paths and per-layer metrics are
files found by name (``lib/cells.py``); ``lib/`` holds the yardstick that
later changes to the program cannot move, and ``reference/`` the plain
PyTorch solve that decides ``correct``.
"""
