"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on the card.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; ``bench/README.md``
has the contract and how to add a configuration, a mix or a metric.
"""
