"""The port's benchmark: the harness, its yardstick and its data.

``perfbench/run.py`` runs one cell once; ``BENCHMARK.json`` at the root of
the repository names the cells, their configurations (``configs/``),
traffic mixes (``traffic/``), limits (``limits/``) and metrics, each read
by a file of its own under ``metrics/``.
"""
