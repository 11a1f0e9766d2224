"""``repro_torch.kernels.stencil.stencil_iterate`` with ``tile=None`` (the
planner splits the chain into launches): the mix's ``time_steps`` Jacobi
steps of one operator, zero fill past the grid."""

import numpy as np


def make(config, mix, taps, weights, device):
    from repro_torch.kernels import stencil as st

    if config.get("boundary", "zero") != "zero":
        raise ValueError("stencil_iterate(offsets, weights, T) fills with "
                         "zeros; a configuration with another boundary "
                         "needs an entry that passes it")
    offs = np.asarray(taps, dtype=np.int64)
    steps = int(mix["time_steps"])
    dev = str(device)

    def call(u):
        return st.stencil_iterate(u, offs, weights, steps, device=dev)

    return call
