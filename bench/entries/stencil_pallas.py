"""``repro_torch.kernels.stencil.stencil_pallas`` with ``tile=None`` (the
planner decides) and the mix's ``time_steps``: the port's single-array
entry, which fills with zeros past the grid."""

import numpy as np


def make(config, mix, taps, weights, device):
    from repro_torch.kernels import stencil as st

    if config.get("boundary", "zero") != "zero":
        raise ValueError("stencil_pallas fills with zeros; a configuration "
                         "with another boundary needs an entry that passes it")
    offs = np.asarray(taps, dtype=np.int64)
    steps = int(mix["time_steps"])
    dev = str(device)

    def call(u):
        return st.stencil_pallas(u, offs, weights, time_steps=steps,
                                 device=dev)

    return call
