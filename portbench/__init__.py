"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; README.md says how
to add a configuration, a traffic mix or a metric as files of their own.
"""
