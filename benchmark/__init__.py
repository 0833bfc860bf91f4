"""The benchmark of ``aide_tpu_torch`` on one CUDA card.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON result line.
Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by its name (``benchmark.manifest``).
"""
