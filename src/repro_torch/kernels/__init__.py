"""The port's kernels: two hand-written CUDA sweep kernels (``csrc/``),
their ctypes wrappers and plain versions (``sweep``), the host-side launch
path (``stencil``), the public API (``ops``) and the oracles (``ref``)."""
