"""Stencil offset tables of the paper's experiments.

A copy of ``star_stencil`` from the JAX package's ``core/cache_fitting``;
the cache-fitting visit orders and bounds there are not part of the port
yet.
"""

from __future__ import annotations

import numpy as np

__all__ = ["star_stencil"]


def star_stencil(d: int, r: int) -> np.ndarray:
    """Offsets of the star stencil: origin plus ±k·e_i, k<=r.  Size 2dr+1.

    The paper's "13-point star" is d=3, r=2 (1 + 2·2·3 = 13).
    """
    offs = [np.zeros(d, dtype=np.int64)]
    for i in range(d):
        for k in range(1, r + 1):
            for s in (-1, 1):
                v = np.zeros(d, dtype=np.int64)
                v[i] = s * k
                offs.append(v)
    return np.stack(offs)
