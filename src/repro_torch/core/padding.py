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
table and the logits have the reference's shape).

The layout half keeps the reference's names, ``tpu_layout_waste`` and
``advise_dim``, and scores the card's grains by default.  Given the
reference's explicit arguments (``tile=(8, 128)``, ``unit=128``) they
return the reference's values.  The grains, and where each comes from:

* the launch buffer: ``kernels/stencil.py::_launch_inputs`` rounds every
  dim of a grid up to the launch tile and adds the window halo on both
  sides (``lo + round_up(n, t) + hi``).  Chain, periodic, quantized and
  sharded launches read that buffer, so its slack is what they waste; a
  plain application reads the caller's array and builds none;
* the 128-byte line (``core/tiling.py::LINE_BYTES``, 32 f32 or 64 bf16
  elements): a warp's row read moves whole L2 lines, and the planner
  takes minor tile extents in whole lines (``minor_unit``), so a minor
  extent that is not a whole number of lines pays the rest of the line;
* the 16-byte ``cp.async`` block of ``csrc/sweep_common.cuh``: the apply
  kernel copies window rows by its flat index only where the input's
  pitches are whole blocks and each window row is whole blocks with at
  most a 4- or 8-byte piece at each end.  A minor extent rounded to a
  line does not make the pitches so, and on a padded buffer ``lo + hi``
  decides (4 f32 elements are a block, 4 bf16 elements are not).
"""

from __future__ import annotations

import itertools
from math import prod
from typing import Sequence

from .lattice import InterferenceLattice
from .tiling import minor_unit

__all__ = [
    "shortest_len",
    "is_unfavorable",
    "hyperbola_index",
    "pad_grid",
    "tpu_pad_dim",
    "tpu_layout_waste",
    "advise_dim",
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


# ---------------------------------------------------------------------------
# Layout lattice of the card (the reference's TPU (8, 128) tiling, rebuilt).
# ---------------------------------------------------------------------------

def tpu_pad_dim(n: int, unit: int) -> int:
    """Round ``n`` up to a multiple of ``unit``."""
    return -(-n // unit) * unit


def tpu_layout_waste(
    shape: Sequence[int],
    tile: Sequence[int] | None = None,
    halo: int | Sequence[tuple[int, int]] = 0,
    dtype_bytes: int = 4,
) -> float:
    """Fraction of a launch buffer that is padding: ``1 - prod(shape) /
    buffer elements``; 0.0 means nothing is wasted.

    The buffer is the one ``kernels/stencil.py::_launch_inputs`` builds:
    per dim, ``lo + round_up(n, t) + hi``.  Only chain, periodic,
    quantized and sharded launches build it now; a plain application
    reads the caller's grid and wastes nothing here.  ``tile`` gives
    ``t`` for the trailing ``len(tile)`` dims (leading dims are not
    rounded; a shape of fewer dims gets leading 1s).  ``None`` is one 128-byte line on the
    minor dim (``minor_unit(dtype_bytes)`` elements) and 1 elsewhere: the
    planner's minor grain.  ``halo`` is the window radius on every dim or
    one ``(lo, hi)`` pair per dim of ``shape``.  With the reference's
    ``tile=(8, 128)`` and no halo this is the reference's TPU figure."""
    shape = tuple(int(n) for n in shape)
    if tile is None:
        tile = (minor_unit(dtype_bytes),)
    tile = tuple(int(t) for t in tile)
    if len(shape) < len(tile):
        shape = (1,) * (len(tile) - len(shape)) + shape
    d = len(shape)
    if isinstance(halo, int):
        halo = [(halo, halo)] * d
    if len(halo) != d:
        raise ValueError(f"{len(halo)} halo pairs for a {d}-D shape")
    tiles = (1,) * (d - len(tile)) + tile
    alloc = prod(int(lo) + tpu_pad_dim(n, t) + int(hi)
                 for n, t, (lo, hi) in zip(shape, tiles, halo))
    return 1.0 - prod(shape) / alloc


def advise_dim(
    n: int,
    unit: int | None = None,
    max_waste: float = 0.05,
    dtype_bytes: int = 4,
) -> dict:
    """Padding advice for one extent (a grid's minor dim, a model's vocab,
    d_ff, head_dim ...): the extent rounded up to ``unit`` elements, the
    fraction of the rounded extent that is padding, and whether that
    fraction exceeds ``max_waste`` ('unfavorable').  ``unit=None`` is one
    128-byte line of ``dtype_bytes`` elements (``minor_unit``): 32 f32, 64
    bf16.  The reference's keys; with its ``unit=128``, its values."""
    if unit is None:
        unit = minor_unit(dtype_bytes)
    padded = tpu_pad_dim(n, unit)
    waste = 1.0 - n / padded
    return {
        "dim": n,
        "padded": padded,
        "waste_if_padded_layout": waste,
        "unfavorable": waste > max_waste,
    }
