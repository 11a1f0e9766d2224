"""The plain reference the benchmark judges the port by.

Plain PyTorch only: nothing here imports ``jax``, the JAX package or
anything of ``repro_torch`` (a CPU test walks the imports)."""
