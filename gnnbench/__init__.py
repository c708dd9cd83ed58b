"""gnnbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell once (see ``README.md``):

    python3 gnnbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations and metrics are listed in ``BENCHMARK.json`` at
the repository's root; each configuration, traffic mix, cell and
per-layer metric has a file of its own under this folder, found by its
name.  Nothing here imports ``jax`` or the JAX package ``repro``.
"""
