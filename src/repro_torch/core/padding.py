"""Unfavorable grid detection and padding advisor (paper §6, Appendix B).

A grid is *unfavorable* when its interference lattice has a very short
vector — shorter than the stencil diameter divided by the cache
associativity — because then the scanning face self-interferes and misses
spike (paper Fig. 4/5).  Empirically these grids satisfy
``n1·n2 ≈ k·S/2`` (Fig. 5 hyperbolae).

The advisor pads leading dimensions minimally until the shortest lattice
vector clears the threshold, preferring the *shortest admissible* vector
above it (wide pencils ⇒ fewer pencil walls, §6).  Appendix B guarantees a
favorable padding exists.

A copy of the paper half of the JAX package's ``core/padding``, plus
``tpu_pad_dim``, which ``ModelCfg.vocab_padded`` rounds the vocabulary
with (the port pads to the reference's multiple of 128, so the embedding
table and the logits have the reference's shape).  The TPU layout-lattice
helpers (``tpu_layout_waste``, ``advise_dim``) are not ported.
"""

from __future__ import annotations

import itertools
from math import prod
from typing import Sequence

from .lattice import InterferenceLattice

__all__ = [
    "shortest_len",
    "is_unfavorable",
    "hyperbola_index",
    "pad_grid",
    "tpu_pad_dim",
]


def shortest_len(dims: Sequence[int], S: int, norm: str = "l1") -> float:
    return InterferenceLattice(tuple(int(n) for n in dims), S).shortest_len(norm)


def is_unfavorable(
    dims: Sequence[int], S: int, diameter: int, a: int = 1, norm: str = "l1"
) -> bool:
    """§6 criterion: shortest lattice vector < diameter / associativity."""
    return shortest_len(dims, S, norm) < diameter / a


def hyperbola_index(dims: Sequence[int], S: int) -> tuple[int, float]:
    """Nearest k and relative distance for the Fig. 5 fit n1·n2 ≈ k·S/2."""
    m = prod(int(n) for n in dims[:-1]) if len(dims) > 2 else int(dims[0]) * int(dims[1])
    half = S / 2.0
    k = max(1, round(m / half))
    return k, abs(m - k * half) / half


def pad_grid(
    dims: Sequence[int],
    S: int,
    diameter: int,
    a: int = 1,
    max_pad: int = 16,
    norm: str = "l1",
) -> tuple[tuple[int, ...], dict]:
    """Minimal padding of the leading d-1 dims making the grid favorable.

    Only dims 1..d-1 (zero-indexed 0..d-2) enter the lattice (the last dim's
    extent never appears in the address strides), so we search paddings of
    those.  Objective: (1) satisfy shortest >= diameter/a, (2) minimize
    extra memory, (3) tie-break toward the *smallest* admissible shortest
    vector so pencils stay wide (§6).

    Guarantees: d=1 grids and already-favorable grids return zero padding
    (a no-op) without searching; the search itself is bounded by the
    ``max_pad`` cap per dim and raises a clear ``ValueError`` when no
    favorable pad exists under it (rather than scanning forever or
    returning something unfavorable).
    """
    dims = tuple(int(n) for n in dims)
    d = len(dims)
    if max_pad < 0:
        raise ValueError(f"max_pad must be >= 0, got {max_pad}")
    target = diameter / a
    before = shortest_len(dims, S, norm)

    def info_for(cand, after):
        return {
            "original": dims,
            "padded": cand,
            "extra_words": prod(cand) - prod(dims),
            "shortest_before": before,
            "shortest_after": after,
            "threshold": target,
        }

    # No-op fast paths: a 1-D grid has no paddable dims (only the leading
    # d-1 dims enter the strides), and a favorable grid needs no help.
    if d == 1 or before >= target:
        return dims, info_for(dims, before)

    def extra_of(pads):
        cand = tuple(
            dims[i] + (pads[i] if i < d - 1 else 0) for i in range(d)
        )
        return prod(cand) - prod(dims), cand

    # Enumerate in order of increasing extra memory so we can stop as soon
    # as the remaining candidates cannot beat the best favorable one.
    ranked = sorted(
        (extra_of(p) for p in itertools.product(range(max_pad + 1), repeat=d - 1)),
        key=lambda ec: ec[0],
    )
    best = None
    for extra, cand in ranked:
        if best is not None and extra > best[0][0]:
            break  # every later candidate costs strictly more memory
        ln = shortest_len(cand, S, norm)
        if ln < target:
            continue
        key = (extra, ln)
        if best is None or key < best[0]:
            best = (key, cand, ln)
    if best is None:
        raise ValueError(
            f"no favorable padding of {dims} within +{max_pad} per leading "
            f"dim (S={S}, shortest {before:.3g} < threshold {target:.3g}); "
            f"raise max_pad — Appendix B guarantees a favorable pad exists"
        )
    _, cand, ln = best
    return cand, info_for(cand, ln)


def tpu_pad_dim(n: int, unit: int) -> int:
    """Round ``n`` up to a multiple of ``unit``."""
    return -(-n // unit) * unit
