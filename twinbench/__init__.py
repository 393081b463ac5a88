"""twinbench: the benchmark of the PyTorch and CUDA twin (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` on an NVIDIA GPU.  Everything
that belongs to one configuration, traffic mix, cell or per-layer metric is
a file of its own under this folder, found by its name.
"""
