"""Plain PyTorch oracles for the stencil kernels.

Semantics: ``q = sum_k w_k * shift(u, k)`` under a boundary fill, the
counterpart of the JAX package's ``kernels/ref.py``: the same tap order,
the same weight dtype (the input's) and the same half-even rounding, so
that on the CPU the two agree bit for bit in f32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.cache_fitting import star_stencil

__all__ = [
    "dequantize_ref",
    "quantize_ref",
    "stencil_ref",
    "star_weights_2nd_order",
]


def _pad_index(n: int, r: int, mode: str, device) -> torch.Tensor:
    """Source index of each of the ``n + 2r`` padded positions along one
    axis, as numpy's pad modes "edge", "reflect" and "wrap" define it."""
    i = torch.arange(-r, n + r, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    assert mode == "reflect", mode
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    m = torch.remainder(i, period)
    return torch.where(m < n, m, period - m)


def _pad(u: torch.Tensor, r: int, mode: str) -> torch.Tensor:
    for axis in range(u.ndim):
        idx = _pad_index(u.shape[axis], r, mode, u.device)
        u = torch.index_select(u, axis, idx)
    return u


def stencil_ref(
    u: torch.Tensor,
    offsets: np.ndarray,
    weights: Sequence[float],
    boundary: str = "zero",
    value=0.0,
) -> torch.Tensor:
    """Apply a weighted stencil under a boundary condition.

    offsets: (s, d) integer array; weights: length-s floats.  ``boundary``
    is one of ``"zero"``, ``"dirichlet"`` (constant ``value``),
    ``"neumann"`` (edge replication), ``"reflect"`` (mirror about the
    edge cell), ``"periodic"`` (wrap) and ``"robin"`` (ghost cells
    ``α·u_edge + β`` with ``value = (alpha, beta)``)."""
    d = u.ndim
    offsets = np.asarray(offsets)
    assert offsets.shape[1] == d, (offsets.shape, d)
    r = int(np.abs(offsets).max()) if offsets.size else 0
    if boundary in ("zero", "dirichlet"):
        c = 0.0 if boundary == "zero" else float(value)
        up = torch.nn.functional.pad(u, [r] * (2 * d), value=c)
    elif boundary == "neumann":
        up = _pad(u, r, "edge") if r else u
    elif boundary == "reflect":
        up = _pad(u, r, "reflect") if r else u
    elif boundary == "periodic":
        up = _pad(u, r, "wrap") if r else u
    elif boundary == "robin":
        alpha, beta = (float(value[0]), float(value[1]))
        if r:
            edge = _pad(u, r, "edge")
            interior = torch.nn.functional.pad(
                torch.ones_like(u), [r] * (2 * d)
            )
            up = torch.where(
                interior > 0, edge,
                torch.tensor(alpha, dtype=u.dtype, device=u.device) * edge
                + torch.tensor(beta, dtype=u.dtype, device=u.device),
            )
        else:
            up = u
    else:
        raise ValueError(f"unknown boundary {boundary!r}")
    out = torch.zeros_like(u)
    for off, w in zip(offsets.tolist(), weights):
        sl = tuple(
            slice(r + o, r + o + n) for o, n in zip(off, u.shape)
        )
        out = out + torch.tensor(w, dtype=u.dtype, device=u.device) * up[sl]
    return out


def quantize_ref(x: torch.Tensor, scale: float, zero_point: int = 0):
    """Affine int8 quantization ``clip(round(x / scale) + zp, -128, 127)``
    with IEEE half-even rounding (``torch.round``).  The divisor is a
    tensor, so that a CUDA tensor gets the IEEE quotient too (a Python
    scalar divisor becomes a multiply by its reciprocal there)."""
    s = torch.tensor(np.float32(scale).item(), device=x.device)
    q = torch.round(x.to(torch.float32) / s)
    q = torch.clamp(q + float(int(zero_point)), -128.0, 127.0)
    return q.to(torch.int8)


def dequantize_ref(q: torch.Tensor, scale: float, zero_point: int = 0):
    """Inverse of :func:`quantize_ref`: ``(q - zp) · scale`` in f32."""
    return (
        q.to(torch.float32) - float(int(zero_point))
    ) * np.float32(scale).item()


def star_weights_2nd_order(d: int, r: int = 2) -> tuple[np.ndarray, list[float]]:
    """The paper's experimental operator: a second-order star stencil
    (13-point for d=3, r=2), with the classic 4th-order accurate Laplacian
    coefficients along each axis."""
    offsets = star_stencil(d, r)
    weights: list[float] = []
    for off in offsets:
        nz = [o for o in off if o != 0]
        if not nz:
            weights.append(-2.5 * d)
        elif abs(nz[0]) == 1:
            weights.append(4.0 / 3.0)
        else:
            weights.append(-1.0 / 12.0)
    return offsets, weights
