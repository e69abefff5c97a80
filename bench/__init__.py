"""The benchmark of the PyTorch and CUDA port: ``python3 bench/run.py``.

Everything a cell needs is found by name (``bench/harness.py``); the
yardstick (the traffic generator, the reference, the byte counts and the
metric readers) lives here and imports nothing of the JAX package."""
