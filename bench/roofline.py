"""The least time a stencil call's work can take on one H100 SXM.

A frozen copy of ``chip_smoke.py``'s ``bound`` arithmetic, counted from
the problem and not from the launches, so it reads the same whatever
implements the call: each unpadded input read once and the output written
once at the HBM rate, or 2 flops per tap per grid point per time step at
the f32 rate outside the tensor cores, whichever is longer.  Halos, tile
round-up, launch buffers, recomputed overlap and intermediate time steps
are the implementation's own work and are not counted.

The rates are NVIDIA's published H100 SXM figures (dense, at the 700 W
power limit); the result line carries the card's own name and limit.
"""

from __future__ import annotations

from math import prod

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, HBM3
F32_FLOPS_PER_S = 67e12    # H100 SXM data sheet, f32 outside the tensor cores


def work(shape, taps: int, steps: int, itemsize: int, n_in: int = 1) -> dict:
    """Bytes, flops and least seconds of one call: ``steps`` applications
    of a ``taps``-point operator to ``n_in`` grids of ``shape`` with
    ``itemsize``-byte elements, giving one grid of the same shape."""
    n = prod(int(s) for s in shape)
    nbytes = n_in * n * itemsize + n * itemsize
    flops = 2 * taps * n * steps
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_flops = flops / F32_FLOPS_PER_S
    return {
        "bytes": nbytes,
        "flops": flops,
        "least_s": max(t_bytes, t_flops),
        "bound_by": "bytes" if t_bytes >= t_flops else "operations",
    }
