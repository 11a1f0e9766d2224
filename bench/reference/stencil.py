"""Weighted stencils under a boundary condition, as shifted-slice sums.

The semantics the port's stencil entries promise: one time step is
``y[x] = sum_t w_t * u[x + o_t]``, where a read outside the grid takes
the boundary's ghost value.  ``boundary`` is one of

* ``"zero"``: every point outside reads 0 (homogeneous Dirichlet, the
  port's default);
* ``"dirichlet"``: every point outside reads ``value``;
* ``"neumann"``: the nearest edge cell (numpy's pad mode ``"edge"``);
* ``"reflect"``: the mirror image about the edge cell, the edge not
  repeated (numpy's ``"reflect"``);
* ``"periodic"``: the grid wrapped round (numpy's ``"wrap"``).

Written from those definitions alone, with its own tap lists, so it
shares no code and no derived table with the program.
"""

from __future__ import annotations

import itertools

import torch

__all__ = ["offsets", "apply", "BOUNDARIES"]

BOUNDARIES = ("zero", "dirichlet", "neumann", "reflect", "periodic")


def offsets(kind: str, radius: int, d: int = 3) -> list[tuple[int, ...]]:
    """The taps of a ``"star"`` (the origin, then +-k along each axis for
    k = 1..radius, axis by axis) or a ``"box"`` (every offset with all
    coordinates in [-radius, radius], the first axis slowest)."""
    if kind == "star":
        taps = [(0,) * d]
        for axis in range(d):
            for k in range(1, radius + 1):
                for s in (-1, 1):
                    o = [0] * d
                    o[axis] = s * k
                    taps.append(tuple(o))
        return taps
    if kind == "box":
        return list(itertools.product(range(-radius, radius + 1), repeat=d))
    raise ValueError(f"unknown stencil kind {kind!r}")


def _source(n: int, r: int, boundary: str, device) -> torch.Tensor:
    """The grid index each of the ``n + 2r`` padded positions of one axis
    reads under an index-mapped ``boundary``."""
    i = torch.arange(-r, n + r, device=device)
    if boundary == "neumann":
        return i.clamp(0, n - 1)
    if boundary == "periodic":
        return torch.remainder(i, n)
    if n == 1:  # reflect
        return torch.zeros_like(i)
    m = torch.remainder(i, 2 * (n - 1))
    return torch.where(m < n, m, 2 * (n - 1) - m)


def _padded(x: torch.Tensor, r, boundary: str, value: float) -> torch.Tensor:
    if boundary in ("zero", "dirichlet"):
        fill = 0.0 if boundary == "zero" else float(value)
        out = torch.full([n + 2 * ri for n, ri in zip(x.shape, r)], fill,
                         dtype=x.dtype, device=x.device)
        out[tuple(slice(ri, ri + n) for ri, n in zip(r, x.shape))] = x
        return out
    for axis, ri in enumerate(r):
        if ri:
            x = torch.index_select(
                x, axis, _source(x.shape[axis], ri, boundary, x.device))
    return x


def apply(u: torch.Tensor, taps, weights, steps: int = 1,
          dtype: torch.dtype = torch.float64,
          out_dtype: torch.dtype | None = None,
          boundary: str = "zero", value: float = 0.0) -> torch.Tensor:
    """``steps`` applications of the stencil to ``u`` under ``boundary``,
    each computed and stored in ``dtype``, the result returned in
    ``out_dtype`` (default: ``u``'s dtype).  A one-byte float ``dtype``
    (float8), which has no arithmetic of its own, stores the input and
    each step's result in it and computes in float32 between."""
    if boundary not in BOUNDARIES:
        raise ValueError(f"unknown boundary {boundary!r}; one of "
                         f"{BOUNDARIES}")
    d = u.ndim
    r = [max(abs(o[i]) for o in taps) for i in range(d)]
    compute = torch.float32 if dtype.itemsize == 1 else dtype
    x = u.to(dtype).to(compute)
    for _ in range(steps):
        padded = _padded(x, r, boundary, value)
        acc = torch.zeros_like(x)
        for o, w in zip(taps, weights):
            window = tuple(
                slice(ri + oi, ri + oi + n)
                for ri, oi, n in zip(r, o, x.shape)
            )
            acc.add_(padded[window], alpha=float(w))
        del padded
        x = acc.to(dtype).to(compute)
    return x.to(u.dtype if out_dtype is None else out_dtype)
