"""Interference lattice of a structured grid (paper §4, Eq. 8/9).

The *interference lattice* L of an array with (Fortran-order) dimensions
``(n_1, ..., n_d)`` stored in a cache of ``S`` words is the set of index
offsets that map to the same cache location as the origin:

    i_1 + n_1 i_2 + n_1 n_2 i_3 + ... + (n_1...n_{d-1}) i_d  ==  0  (mod S)

Eq. 9 gives an explicit basis:

    v_1 = S e_1,   v_i = -m_i e_1 + e_i   (2 <= i <= d),   m_i = prod_{j<i} n_j

This module provides the basis, exact LLL reduction (rational arithmetic,
fine for d <= 6), shortest-vector search, and membership tests.  Everything
here is plain Python/numpy — it runs at config/trace time, never inside a
jitted computation.

A copy of the JAX package's ``core/lattice`` (numpy only),
held equal to it by ``tests/test_torch_paper_core.py``.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Sequence

import numpy as np

__all__ = [
    "CacheGeometry",
    "fortran_strides",
    "interference_basis",
    "lattice_contains",
    "lll_reduce",
    "is_lll_reduced",
    "shortest_vector",
    "basis_eccentricity",
    "InterferenceLattice",
]


@dataclass(frozen=True)
class CacheGeometry:
    """(a, z, w) cache: ``a`` sets-associativity, ``z`` sets, ``w`` words/line.

    The paper's R10000 example is (2, 512, 4): 4K double words = 32 KB.
    """

    a: int = 2
    z: int = 512
    w: int = 4

    @property
    def size_words(self) -> int:  # S = a*z*w
        return self.a * self.z * self.w

    @property
    def set_span_words(self) -> int:
        """Address period of the set mapping (z*w): offsets that are 0 mod
        this land in the same set.  Equals S for a direct-mapped cache."""
        return self.z * self.w

    def set_of(self, addr: np.ndarray) -> np.ndarray:
        return (addr // self.w) % self.z

    def tag_of(self, addr: np.ndarray) -> np.ndarray:
        return addr // (self.w * self.z)


def fortran_strides(dims: Sequence[int]) -> np.ndarray:
    """Column-major strides (1, n1, n1*n2, ...) — the paper's layout."""
    dims = np.asarray(dims, dtype=np.int64)
    return np.concatenate([[1], np.cumprod(dims[:-1])]).astype(np.int64)


def interference_basis(dims: Sequence[int], S: int) -> np.ndarray:
    """Eq. 9 basis of the interference lattice, rows = basis vectors."""
    d = len(dims)
    m = fortran_strides(dims)  # m_i = prod_{j<i} n_j ; m[0] = 1
    B = np.zeros((d, d), dtype=np.int64)
    B[0, 0] = S
    for i in range(1, d):
        B[i, 0] = -int(m[i])
        B[i, i] = 1
    return B


def lattice_contains(dims: Sequence[int], S: int, vec: Sequence[int]) -> bool:
    """Membership test straight from Eq. 8."""
    m = fortran_strides(dims)
    return int(np.dot(m, np.asarray(vec, dtype=np.int64))) % S == 0


# ---------------------------------------------------------------------------
# Exact LLL reduction.
# ---------------------------------------------------------------------------

def _gram_schmidt(B: list[list[int]]):
    """Exact GS over Q. Returns (mu, Bstar_sq) with mu lower-triangular."""
    n = len(B)
    mu = [[Fraction(0)] * n for _ in range(n)]
    bstar: list[list[Fraction]] = []
    Bsq: list[Fraction] = []
    for i in range(n):
        v = [Fraction(x) for x in B[i]]
        for j in range(i):
            if Bsq[j] == 0:
                mu[i][j] = Fraction(0)
                continue
            num = sum(Fraction(B[i][k]) * bstar[j][k] for k in range(len(v)))
            mu[i][j] = num / Bsq[j]
            v = [v[k] - mu[i][j] * bstar[j][k] for k in range(len(v))]
        bstar.append(v)
        Bsq.append(sum(x * x for x in v))
    return mu, Bsq


def lll_reduce(basis: np.ndarray, delta: Fraction = Fraction(3, 4)) -> np.ndarray:
    """Textbook LLL with exact rational Gram-Schmidt.  Rows are vectors.

    Guarantees ``prod ||b_i|| <= 2^{d(d-1)/4} det L`` (the paper's reduced
    basis with c_d = 2^{d(d-1)/4}, footnote ‡ of §4).
    """
    B = [[int(x) for x in row] for row in np.asarray(basis)]
    n = len(B)
    if n <= 1:
        return np.asarray(B, dtype=np.int64)
    mu, Bsq = _gram_schmidt(B)
    k = 1
    # Size-reduce + Lovász swap loop.  d <= 6 here, so recomputing GS is cheap.
    while k < n:
        for j in range(k - 1, -1, -1):
            q = _nearest_int(mu[k][j])
            if q != 0:
                B[k] = [x - q * y for x, y in zip(B[k], B[j])]
                mu, Bsq = _gram_schmidt(B)
        if Bsq[k] >= (delta - mu[k][k - 1] ** 2) * Bsq[k - 1]:
            k += 1
        else:
            B[k], B[k - 1] = B[k - 1], B[k]
            mu, Bsq = _gram_schmidt(B)
            k = max(k - 1, 1)
    return np.asarray(B, dtype=np.int64)


def _nearest_int(x: Fraction) -> int:
    return int((x + Fraction(1, 2)).__floor__()) if x >= 0 else -int((-x + Fraction(1, 2)).__floor__())


def is_lll_reduced(basis: np.ndarray, delta: Fraction = Fraction(3, 4)) -> bool:
    """Check the LLL conditions (size reduction + Lovász) in one exact
    Gram-Schmidt pass.

    This is O(d^3) rational arithmetic — the cost of a *single* GS — versus
    the full reduction loop, which recomputes GS after every size-reduction
    and swap.  ``shortest_vector`` uses it to skip re-reducing an
    already-reduced basis (every planner call site hands it one), so the
    planner pays LLL once per lattice, not twice.
    """
    B = [[int(x) for x in row] for row in np.asarray(basis)]
    n = len(B)
    if n <= 1:
        return True
    mu, Bsq = _gram_schmidt(B)
    half = Fraction(1, 2)
    for i in range(n):
        for j in range(i):
            if abs(mu[i][j]) > half:
                return False
    for k in range(1, n):
        if Bsq[k] < (delta - mu[k][k - 1] ** 2) * Bsq[k - 1]:
            return False
    return True


def shortest_vector(
    basis: np.ndarray, norm: str = "l2", radius: int = 2
) -> np.ndarray:
    """Shortest nonzero lattice vector by enumeration around an LLL basis.

    For an LLL-reduced basis in d <= 4, coefficients of the shortest vector
    are bounded by a small constant; ``radius=2`` is exact for every case in
    the paper's experiments and we expose ``radius`` for paranoia.

    An input that already satisfies the LLL conditions is used as-is
    (checked with one Gram-Schmidt pass) — callers that reduced the basis
    themselves don't pay the exact-rational reduction a second time.
    """
    B = np.asarray(basis, dtype=np.int64)
    if not is_lll_reduced(B):
        B = lll_reduce(B)
    d = B.shape[0]
    best = None
    best_len = None
    for coeffs in itertools.product(range(-radius, radius + 1), repeat=d):
        if not any(coeffs):
            continue
        v = np.dot(np.asarray(coeffs, dtype=np.int64), B)
        ln = _norm(v, norm)
        if best_len is None or ln < best_len:
            best, best_len = v, ln
    return best


def _norm(v: np.ndarray, norm: str) -> float:
    if norm == "l1":
        return float(np.abs(v).sum())
    if norm == "linf":
        return float(np.abs(v).max())
    return float(np.sqrt((v.astype(np.float64) ** 2).sum()))


def basis_eccentricity(B: np.ndarray) -> float:
    """e = max ||b_i|| / min ||b_i|| of a (reduced) basis — §4, Eq. 11."""
    lens = np.sqrt((B.astype(np.float64) ** 2).sum(axis=1))
    return float(lens.max() / lens.min())


@dataclass
class InterferenceLattice:
    """Bundles everything the cache-fitting algorithm needs for one array."""

    dims: tuple[int, ...]
    S: int
    basis: np.ndarray = field(init=False)
    reduced: np.ndarray = field(init=False)

    def __post_init__(self):
        self.basis = interference_basis(self.dims, self.S)
        self.reduced = lll_reduce(self.basis)

    @property
    def d(self) -> int:
        return len(self.dims)

    def shortest(self, norm: str = "l2") -> np.ndarray:
        return shortest_vector(self.reduced, norm=norm)

    def shortest_len(self, norm: str = "l2") -> float:
        return _norm(self.shortest(norm=norm), norm)

    @property
    def eccentricity(self) -> float:
        return basis_eccentricity(self.reduced)

    def det(self) -> int:
        """det L = S (proved under Eq. 9)."""
        return abs(int(round(np.linalg.det(self.reduced.astype(np.float64)))))

    def contains(self, vec: Sequence[int]) -> bool:
        return lattice_contains(self.dims, self.S, vec)
