"""The port's benchmark: routed serving and LM training of ``repro_torch``
on one NVIDIA card, driven by the data files beside this package.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the repository root runs one cell of
``BENCHMARK.json`` and prints one JSON line last. Nothing here imports
JAX, the JAX package ``repro`` or ``benchmarks/``.
"""
