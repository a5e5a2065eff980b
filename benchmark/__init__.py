"""The benchmark of ``dropoutdecoding_tpu_torch`` on an NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON line.
Everything that belongs to one configuration, traffic mix, cell or metric is
a file of its own that ``registry.py`` finds by name: ``configs/``,
``traffic/``, ``limits/``, ``metrics/``, ``kernels/``.  ``drivers/`` hold
the general drivers that a traffic mix names, ``reference/`` the plain
fp32 PyTorch reference that decides ``correct``.
"""
