"""The benchmark of the PyTorch and CUDA port (``repro_torch``): DiskJoin
self-joins and ε-range serving on one H100. ``run.py`` runs one cell;
``BENCHMARK.json`` at the root of the checkout lists the cells."""
