"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): YCSB cells
on RemixDB and its serving front, one H100. ``run.py`` runs one cell once;
``BENCHMARK.json`` at the checkout's root names the cells, the
configurations and the metrics."""
