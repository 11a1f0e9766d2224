"""Discrete isoperimetry and the paper's lower bounds (§3, §5, Appendix A).

Counts of integer points in the standard octahedron / simplex (Eqs. 15-25)
and the cache-load lower bounds Eq. 7 (single array) and Eq. 13 (p RHS
arrays).  Pure Python integer math.

A copy of the JAX package's ``core/isoperimetric`` (numpy only),
held equal to it by ``tests/test_torch_paper_core.py``.
"""

from __future__ import annotations

from functools import lru_cache
from math import comb, prod
from typing import Sequence

__all__ = [
    "octahedron_volume",
    "octahedron_boundary",
    "simplex_volume",
    "octahedron_volume_recurrence",
    "boundary_recurrence_holds",
    "c_d",
    "lower_bound_loads",
    "choose_sigma_t",
]


@lru_cache(maxsize=None)
def octahedron_volume(d: int, t: int) -> int:
    """|O(d,t)| = sum_k 2^k C(d,k) C(t,k)   (Eq. 18)."""
    if t < 0:
        return 0
    return sum((1 << k) * comb(d, k) * comb(t, k) for k in range(d + 1))


@lru_cache(maxsize=None)
def octahedron_boundary(d: int, t: int) -> int:
    """|δO(d,t)| = |O(d,t+1)| - |O(d,t)| = sum_k 2^k C(d,k) C(t,k-1)  (Eq. 19).

    Note Eq. 19 is stated for δO(d, t-1); shifting gives this form.
    Defined for any t via the volume difference (δO(d,-1) = |O(d,0)| = 1).
    """
    return octahedron_volume(d, t + 1) - octahedron_volume(d, t)


@lru_cache(maxsize=None)
def simplex_volume(d: int, t: int) -> int:
    """|S(d,t)| = C(d+t, d)   (Eq. 23)."""
    if t < 0:
        return 0
    return comb(d + t, d)


def octahedron_volume_recurrence(d: int, t: int) -> int:
    """Eq. 17 — used by property tests against the closed form."""
    if d == 0:
        return 1
    if t < 0:
        return 0
    return octahedron_volume(d - 1, t) + 2 * sum(
        octahedron_volume(d - 1, k) for k in range(t)
    )


def boundary_recurrence_holds(d: int, t: int) -> bool:
    """Eq. 20: |δO(d,t)| = |δO(d,t-1)| + |δO(d-1,t)| + |δO(d-1,t-1)|."""
    lhs = octahedron_boundary(d, t)
    rhs = (
        octahedron_boundary(d, t - 1)
        + octahedron_boundary(d - 1, t)
        + octahedron_boundary(d - 1, t - 1)
    )
    return lhs == rhs


def c_d(d: int) -> float:
    """c_d = 1 / (d (2d+1) 2^{d+2})  — the constant under Eq. 5."""
    return 1.0 / (d * (2 * d + 1) * (1 << (d + 2)))


def choose_sigma_t(d: int, S: int) -> tuple[int, int]:
    """Smallest t with |δO(d,t)| >= 8 d S  (Eq. 4).  Returns (t, sigma).

    Eq. 21 guarantees sigma < 8d(2d+1)S for this t.
    """
    t = 0
    while octahedron_boundary(d, t) < 8 * d * S:
        t += 1
    return t, octahedron_boundary(d, t)


def lower_bound_loads(
    dims: Sequence[int], S: int, p: int = 1
) -> dict[str, float]:
    """Lower bound on cache loads, Eq. 7 (p=1) / Eq. 13 (p>1).

    ``dims`` are the extents of the full grid G; the stencil is assumed to
    contain the star stencil.  Returns the bound plus its pieces so callers
    (benchmarks, EXPERIMENTS.md) can show the derivation.

    Eq. 13:  mu >= p|G| (1 - (2d+1)/l + (1 - 2d/l) c_d ceil(S/p)^{-1/(d-1)})
    """
    d = len(dims)
    if d < 2:
        raise ValueError("the bound is stated for d >= 2")
    G = prod(int(n) for n in dims)
    l = min(int(n) for n in dims)
    Sp = -(-S // p)  # ceil(S/p)
    cd = c_d(d)
    iso = cd * Sp ** (-1.0 / (d - 1))
    bound = p * G * (1.0 - (2 * d + 1) / l + (1.0 - 2 * d / l) * iso)
    return {
        "bound": max(bound, 0.0),
        "compulsory": float(p * G),
        "replacement_fraction": iso,
        "c_d": cd,
        "d": d,
        "S_eff": Sp,
    }
