"""The cache-fitting algorithm (paper §4) and its upper bounds (Eqs. 12/14).

The algorithm sweeps the grid pencil-by-pencil along a short vector ``v`` of
the interference lattice; within a pencil the scanning face ``F + k·v/g``
visits every integer point.  Consecutive face-loads are conflict-free, so
replacement loads only happen within stencil radius ``r`` of pencil walls.

We realize the visit order *exactly* and vectorized: write each grid point x
in lattice coordinates y = x · B^{-1} (rows of B = reduced basis, row 0 = the
sweep vector v).  Then

    pencil id  = (floor(y_2), ..., floor(y_d))      (which pencil)
    sweep key  = y_1                                 (position along v)

and the cache-fitting order is the lexicographic sort by (pencil id, sweep
key).  This is precisely "for each pencil Q: for k: compute q at F + k·w".

A copy of the JAX package's ``core/cache_fitting`` (numpy only),
held equal to it by ``tests/test_torch_paper_core.py``.
"""

from __future__ import annotations

from math import prod
from typing import Sequence

import numpy as np

from .isoperimetric import c_d as iso_c_d  # noqa: F401  (re-export convenience)
from .lattice import InterferenceLattice, fortran_strides

__all__ = [
    "star_stencil",
    "box_stencil",
    "natural_order",
    "cache_fitting_order",
    "access_stream",
    "lll_c_d",
    "upper_bound_loads",
    "rhs_array_offsets",
]


# ---------------------------------------------------------------------------
# Stencils.
# ---------------------------------------------------------------------------

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


def box_stencil(d: int, r: int) -> np.ndarray:
    """Full (2r+1)^d cube stencil."""
    ax = np.arange(-r, r + 1, dtype=np.int64)
    grids = np.meshgrid(*([ax] * d), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)


# ---------------------------------------------------------------------------
# Visit orders.
# ---------------------------------------------------------------------------

def _interior_points(dims: Sequence[int], r: int) -> np.ndarray:
    """All points of the K-interior R (distance >= r from every wall),
    shape (N, d), int64.  Fortran-style: first index fastest."""
    axes = [np.arange(r, n - r, dtype=np.int64) for n in dims]
    grids = np.meshgrid(*axes, indexing="ij")
    # Fortran order: make axis 0 vary fastest.
    pts = np.stack([g.ravel(order="F") for g in grids], axis=-1)
    return pts


def natural_order(dims: Sequence[int], r: int) -> np.ndarray:
    """The naturally ordered loop nest of the paper's Fortran codes:
    i1 innermost (fastest), i_d outermost."""
    return _interior_points(dims, r)


def _order_for_sweep(dims, r, B, sweep_idx: int) -> np.ndarray:
    d = B.shape[0]
    order = [sweep_idx] + [j for j in range(d) if j != sweep_idx]
    Bo = B[order]
    pts = _interior_points(dims, r)
    # y = x · B^{-1}  (rows of B are basis vectors; x = y · B)
    y = np.linalg.solve(Bo.T, pts.T.astype(np.float64)).T
    pencil = np.floor(y[:, 1:] + 1e-9).astype(np.int64)
    # lexsort: last key is primary ⇒ feed sweep key first, pencil ids after.
    keys = [y[:, 0]] + [pencil[:, j] for j in range(pencil.shape[1])]
    perm = np.lexsort(keys)
    return pts[perm]


def cache_fitting_order(
    dims: Sequence[int],
    S: int,
    r: int,
    lat: InterferenceLattice | None = None,
    sweep: str | int = "auto",
) -> np.ndarray:
    """Grid points of the K-interior in cache-fitting order (§4).

    sweep: which reduced-basis vector the scanning face advances along.
      'shortest' — the shortest basis vector (the §4 default);
      int        — explicit basis row;
      'auto'     — §6's tuning ("pencils as wide as possible"): score each
                   candidate sweep on a thin slab with the exact simulator
                   and keep the best.  Costs d extra thin-slab sims.
    """
    dims = tuple(int(n) for n in dims)
    lat = lat or InterferenceLattice(dims, S)
    B = lat.reduced.astype(np.float64)
    lens = np.sqrt((B ** 2).sum(axis=1))
    if isinstance(sweep, int):
        return _order_for_sweep(dims, r, B, sweep)
    if sweep == "shortest":
        return _order_for_sweep(dims, r, B, int(np.argmin(lens)))
    # auto: exact-score candidates on a thin slab
    from .cache_sim import simulate_misses
    from .lattice import CacheGeometry

    slab = dims[:-1] + (min(dims[-1], 4 * r + 4),)
    K = star_stencil(len(dims), r)
    geom = CacheGeometry(1, S, 1)  # direct-mapped scoring (worst case, §4)
    best_idx, best_m = 0, None
    for j in range(B.shape[0]):
        o = _order_for_sweep(slab, r, B, j)
        m = simulate_misses(access_stream(slab, o, K), geom)
        if best_m is None or m < best_m:
            best_idx, best_m = j, m
    return _order_for_sweep(dims, r, B, best_idx)


# ---------------------------------------------------------------------------
# Address streams.
# ---------------------------------------------------------------------------

def access_stream(
    dims: Sequence[int],
    order_pts: np.ndarray,
    offsets: np.ndarray,
    base_u: int = 0,
    base_q: int | None = None,
) -> np.ndarray:
    """Word-address stream of the pointwise stencil computation.

    For each visited point x (rows of ``order_pts``): read u(x+k) for every
    stencil offset k, then write q(x).  Addresses are Fortran-linearized.
    Returns int64 array of length N*(s+1).
    """
    strides = fortran_strides(dims)
    if base_q is None:
        base_q = int(prod(int(n) for n in dims))  # q allocated right after u
    lin = order_pts @ strides  # (N,)
    koff = offsets @ strides  # (s,)
    reads = base_u + lin[:, None] + koff[None, :]  # (N, s)
    writes = base_q + lin[:, None]  # (N, 1)
    return np.concatenate([reads, writes], axis=1).ravel()


# ---------------------------------------------------------------------------
# Upper bounds (Eqs. 12 / 14).
# ---------------------------------------------------------------------------

def plan_schedule(
    dims: Sequence[int],
    S: int,
    r: int,
    geom=None,
) -> tuple[np.ndarray, int, dict]:
    """Auto-tuned cache-fitting schedule for the q = K·u computation.

    Automates the paper's §5/§6 tuning knobs: effective face size (full S
    vs S/p for the p=2 arrays u,q), the q base-address offset (Fig. 3
    image separation), and the sweep basis vector — each variant scored
    *exactly* on a thin slab with the simulator, best kept.  Returns
    (visit_order, base_q, info).
    """
    from .cache_sim import simulate_misses
    from .lattice import CacheGeometry

    dims = tuple(int(n) for n in dims)
    geom = geom or CacheGeometry(1, S, 1)
    G = int(np.prod(dims))
    q_aligned = -(-G // S) * S
    K = star_stencil(len(dims), r)
    # score on the full grid when affordable (exact), else on a thin slab
    if G <= 400_000:
        slab = dims
    else:
        slab = dims[:-1] + (min(dims[-1], 4 * r + 4),)
    slab_aligned = -(-int(np.prod(slab)) // S) * S
    # tuning knobs: effective face size × q cache-image offset δ.  The slab
    # score uses the SAME δ (image position mod S) as the full grid, so the
    # prediction transfers.
    deltas = (G % S, S // 2, 0)
    best = None
    for s_eff in (S, S // 2):
        for delta in deltas:
            o = cache_fitting_order(slab, s_eff, r)
            m = simulate_misses(
                access_stream(slab, o, K, base_q=slab_aligned + delta), geom
            )
            if best is None or m < best[0]:
                best = (m, s_eff, delta)
    _, s_eff, delta = best
    order = cache_fitting_order(dims, s_eff, r)
    base_q = q_aligned + delta
    return order, base_q, {"S_eff": s_eff, "delta": delta, "base_q": base_q}


def lll_c_d(d: int) -> float:
    """Reduced-basis constant c_d = 2^{d(d-1)/4} (§4 footnote ‡)."""
    return 2.0 ** (d * (d - 1) / 4.0)


def upper_bound_loads(
    dims: Sequence[int],
    S: int,
    r: int,
    p: int = 1,
    lat: InterferenceLattice | None = None,
) -> dict[str, float]:
    """Upper bound on cache loads of the cache-fitting algorithm.

    Eq. 12 (p=1):  mu <= |G| (1 + e c''_d S^{-1/d})
    Eq. 14 (p>1):  mu <= p|G| (1 + e c''_d ceil(S/p)^{-1/d})

    with c''_d = r (2r+1)^d c'_d,  c'_d = 2 d c_d,  c_d = 2^{d(d-1)/4},
    and e the eccentricity of the reduced basis (measured, not worst-case).
    """
    d = len(dims)
    lat = lat or InterferenceLattice(tuple(int(n) for n in dims), S)
    e = lat.eccentricity
    G = prod(int(n) for n in dims)
    Sp = -(-S // p)
    cd = lll_c_d(d)
    cpd = 2 * d * cd
    cppd = r * (2 * r + 1) ** d * cpd
    bound = p * G * (1.0 + e * cppd * Sp ** (-1.0 / d))
    return {
        "bound": bound,
        "compulsory": float(p * G),
        "eccentricity": e,
        "c_d": cd,
        "c''_d": cppd,
        "S_eff": Sp,
    }


def rhs_array_offsets(dims: Sequence[int], S: int, p: int) -> list[int]:
    """Base-address offsets for p RHS arrays (§5, Fig. 3).

    Strip-tile the fundamental parallelepiped along its longest edge into p
    pieces and choose array start addresses so the strip images in cache do
    not overlap:  addr_i = addr_1 + m_i S + s_i,  s_i = (i-1)·floor(S/p),
    m_i = m_{i-1} + ceil((|V| - s_i + s_{i-1}) / S).
    """
    V = prod(int(n) for n in dims)
    stride = S // p
    offsets = [0]
    m = 0
    for i in range(1, p):
        s_prev = (i - 1) * stride
        s_i = i * stride
        m += -(-(V - s_i + s_prev) // S)
        offsets.append(m * S + s_i)
    return offsets
