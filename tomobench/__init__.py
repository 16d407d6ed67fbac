"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``):
Savu's tomography chain on detector-sized scans made from a seed.

``BENCHMARK.json`` at the checkout's root names the cells; each cell's
configuration, traffic mix, metric readers and limits are files of their
own here, found by name (``bench``).  ``python3 -m tomobench.run`` runs
one cell once.  Nothing here imports the JAX package or JAX.
"""
