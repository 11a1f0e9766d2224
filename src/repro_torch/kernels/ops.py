"""Public API for the stencil kernels of the port.

``apply_stencil`` is what callers use for one operator application,
``apply_star_2nd_order`` for the paper's measured operator and
``apply_multi_rhs`` for ``q = Σ_p K_p u_p``.  The TPU cost-model reports
of the reference (``plan_tiles``, ``traffic_report``) wait for the Hopper
planner.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .ref import star_weights_2nd_order, stencil_ref
from .stencil import multi_stencil_pallas, stencil_iterate, stencil_pallas

__all__ = [
    "apply_stencil",
    "apply_star_2nd_order",
    "apply_multi_rhs",
    "stencil_iterate",
    "stencil_ref",
    "star_weights_2nd_order",
]


def apply_stencil(
    u,
    offsets: np.ndarray,
    weights: Sequence[float],
    tile: Sequence[int] | None = None,
    sweep_axis: int | None = None,
    pipelined: bool = True,
    time_steps: int = 1,
    device=None,
) -> torch.Tensor:
    """q = K u with zero boundary fill, swept tile by tile on the card.
    ``time_steps=T > 1`` fuses T applications into one launch."""
    return stencil_pallas(
        u, offsets, weights, tile=tile, sweep_axis=sweep_axis,
        pipelined=pipelined, time_steps=time_steps, device=device,
    )


def apply_star_2nd_order(
    u,
    tile: Sequence[int] | None = None,
    sweep_axis: int | None = None,
    device=None,
) -> torch.Tensor:
    """The paper's measured operator: second-order star (13-point in 3-D)."""
    offsets, weights = star_weights_2nd_order(u.ndim, r=2)
    return apply_stencil(
        u, offsets, weights, tile=tile, sweep_axis=sweep_axis, device=device,
    )


def apply_multi_rhs(
    us,
    offsets_list: Sequence[np.ndarray],
    weights_list: Sequence[Sequence[float]],
    tile: Sequence[int] | None = None,
    sweep_axis: int | None = None,
    device=None,
) -> torch.Tensor:
    """q = Σ_p K_p u_p (§5): p windows swept together in one launch."""
    return multi_stencil_pallas(
        us, offsets_list, weights_list, tile=tile, sweep_axis=sweep_axis,
        device=device,
    )
