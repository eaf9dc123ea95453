"""The benchmark of ``pim_compression_tpu_torch`` on one NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json`` once and prints its result
line; see ``README.md``. Nothing here imports JAX or the JAX package.
"""
