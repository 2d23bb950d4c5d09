"""The benchmark of ``repro_torch`` on an NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line. Cells,
configurations, traffic mixes, loops and metrics are files found by name;
see ``harness.py``.
"""
