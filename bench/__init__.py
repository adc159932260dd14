"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one GPU.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
Nothing here imports ``jax`` or the JAX package ``repro``.
"""
