"""Twins of the JAX package's stencil examples, on the port.

Run each as ``python -m repro_torch.examples.<name>`` (with ``src`` on
``PYTHONPATH``): ``quickstart``, ``stencil_pipeline``,
``rk2_damped_jacobi`` and ``multigrid_vcycle``.  Each keeps its
reference's defaults, printout and self-checks, takes ``--device``
(``cuda``, the default, or ``cpu``: the kernels' plain versions) and
exposes ``main(argv)``.
"""
