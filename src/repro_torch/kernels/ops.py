"""Public API for the stencil kernels of the port.

``apply_stencil`` is what callers use for one operator application,
``apply_star_2nd_order`` for the paper's measured operator and
``apply_multi_rhs`` for ``q = Σ_p K_p u_p``.  ``plan_tiles`` reports the
tile decision of the Hopper cost model (``core/tiling.py::select_tile``)
and ``traffic_report`` its modelled device-memory traffic against a
per-tile-halo schedule and the isoperimetric bound, for logging and the
examples.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.tiling import (
    SMEM_BLOCK_LIMIT,
    TileChoice,
    select_tile,
    tile_traffic_bytes,
)
from .ref import star_weights_2nd_order, stencil_ref
from .stencil import multi_stencil_pallas, stencil_iterate, stencil_pallas

__all__ = [
    "apply_stencil",
    "apply_star_2nd_order",
    "apply_multi_rhs",
    "plan_tiles",
    "traffic_report",
    "stencil_iterate",
    "stencil_ref",
    "star_weights_2nd_order",
]


def plan_tiles(
    shape: Sequence[int],
    r: int,
    dtype_bytes: int = 4,
    n_operands: int = 2,
    vmem_budget: int = SMEM_BLOCK_LIMIT,
    sweep_axis: int | str = "auto",
) -> TileChoice:
    """The apply kernel's tile decision for a radius-``r`` operator on
    ``shape``: the tile of least modelled time on the card whose shared
    memory fits ``vmem_budget`` bytes a CTA.  ``n_operands`` counts the
    launch's arrays as the reference does, inputs and the output; the
    output leaves from registers, so ``n_operands - 1`` inputs take shared
    memory.  ``sweep_axis`` is an axis or ``"auto"`` (the reference's
    ``None``, a per-tile halo, is not a launch of the port)."""
    return select_tile(
        shape, [(r, r)] * len(shape), dtype_bytes=dtype_bytes,
        vmem_budget=vmem_budget, sweep_axis=sweep_axis,
        n_inputs=max(n_operands - 1, 1),
    )


def traffic_report(
    shape: Sequence[int],
    r: int,
    dtype_bytes: int = 4,
    vmem_budget: int = SMEM_BLOCK_LIMIT,
    n_operands: int = 2,
    aligned: bool = True,
) -> dict:
    """Modelled device-memory traffic of one radius-``r`` application, in
    bytes, with the reference's keys: the planned sweep (``sweep_reuse``,
    the tile :func:`plan_tiles` picks, whose windows reuse their overlap
    along the sweep axis), a per-tile-halo schedule (``per_tile_halo``)
    and the isoperimetric lower bound.

    The port launches no per-tile-halo schedule (every launch sweeps), so
    ``per_tile_halo`` is a model: the planned tile with each tile reading
    its whole halo, priced by the reference's formula
    (``tile_traffic_bytes(..., sweep_axis=None)``).  Priced on one tile,
    ``lower_bound_bytes <= sweep_reuse <= per_tile_halo`` holds and
    ``traffic_ratio`` is what the sweep's reuse saves on that tile."""
    halo = [(r, r)] * len(shape)
    swept = select_tile(
        shape, halo, dtype_bytes=dtype_bytes, vmem_budget=vmem_budget,
        sweep_axis="auto", aligned=aligned, n_inputs=max(n_operands - 1, 1),
    )
    naive_bytes = tile_traffic_bytes(shape, swept.tile, halo, dtype_bytes,
                                     None)
    return {
        "shape": tuple(int(n) for n in shape),
        "radius": int(r),
        "vmem_budget_bytes": int(vmem_budget),
        "per_tile_halo": {
            "tile": swept.tile,
            "traffic_bytes": naive_bytes,
            "efficiency": swept.lower_bound_bytes / naive_bytes,
        },
        "sweep_reuse": {
            "tile": swept.tile,
            "sweep_axis": swept.sweep_axis,
            "traffic_bytes": swept.traffic_bytes,
            "efficiency": swept.efficiency,
        },
        "lower_bound_bytes": swept.lower_bound_bytes,
        "traffic_ratio": naive_bytes / max(swept.traffic_bytes, 1),
    }


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
