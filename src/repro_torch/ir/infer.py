"""Shape inference for stencil programs (DESIGN.md §13).

Propagates accessed-offset footprints *backward* from the ``store``:
the stored value covers exactly the domain box ``[0, N)``; an ``apply``
grows its operand's box by the stencil reach; ``combine``, ``boundary``,
``quantize``, and ``dequantize`` pass their result box through (the
quantization ops change storage, not geometry); a value read by several
consumers gets the union box.  The derived per-value halos reproduce —
and are pinned by test against — the hand-maintained ``chain_halo`` /
``stage_suffix_halos`` arithmetic in :mod:`repro_torch.core.tiling`.

Like :mod:`repro_torch.ir.ops`, this module is numpy-only.
"""

from __future__ import annotations

from typing import Sequence

from .ops import (
    Apply,
    Boundary,
    Bounds,
    Combine,
    Dequantize,
    Load,
    Program,
    Quantize,
    Store,
)

__all__ = ["infer_bounds", "infer_halos", "stage_halos", "suffix_halos"]


def infer_bounds(program: Program, shape: Sequence[int]) -> dict[str, Bounds]:
    """Per-value bounds boxes for a concrete domain ``shape``.

    The stored value is ``[0, N)``; every other value's box is the union
    of what its consumers demand of it.  Values nothing demands (dead
    code — rejected by verify) are absent from the result.
    """
    if len(shape) != program.d:
        raise ValueError(f"shape {shape} is not {program.d}-dimensional")
    domain = Bounds(lb=(0,) * program.d, ub=tuple(int(n) for n in shape))
    bounds: dict[str, Bounds] = {}

    def demand(name: str, box: Bounds) -> None:
        bounds[name] = box if name not in bounds else bounds[name].union(box)

    for op in reversed(program.ops):
        if isinstance(op, Store):
            demand(op.operand, domain)
        elif isinstance(op, Apply):
            if op.result in bounds:
                demand(op.operand, bounds[op.result].grown(op.offsets))
        elif isinstance(op, (Combine,)):
            if op.result in bounds:
                for name in op.operands:
                    demand(name, bounds[op.result])
        elif isinstance(op, (Boundary, Quantize, Dequantize)):
            if op.result in bounds:
                demand(op.operand, bounds[op.result])
        # Load defines an external input; nothing upstream of it.
    return bounds


def infer_halos(program: Program) -> dict[str, tuple[tuple[int, int], ...]]:
    """Shape-free per-value halos: ``(lo_i, hi_i)`` reach past the domain
    per dim.  Runs :func:`infer_bounds` on a virtual all-zero-size domain
    so the boxes *are* the halos."""
    zero = (0,) * program.d
    # A zero-extent domain makes lb = -lo and ub = +hi directly.
    domain = Bounds(lb=zero, ub=zero)
    halos: dict[str, Bounds] = {}

    def demand(name: str, box: Bounds) -> None:
        halos[name] = box if name not in halos else halos[name].union(box)

    for op in reversed(program.ops):
        if isinstance(op, Store):
            demand(op.operand, domain)
        elif isinstance(op, Apply):
            if op.result in halos:
                demand(op.operand, halos[op.result].grown(op.offsets))
        elif isinstance(op, Combine):
            if op.result in halos:
                for name in op.operands:
                    demand(name, halos[op.result])
        elif isinstance(op, (Boundary, Quantize, Dequantize)):
            if op.result in halos:
                demand(op.operand, halos[op.result])
    return {
        name: tuple((-l, u) for l, u in zip(box.lb, box.ub))
        for name, box in halos.items()
    }


def stage_halos(program: Program) -> list[tuple[tuple[int, int], ...]]:
    """Per-apply *operator* halos, in program order — each stage's own
    offset reach, the quantity ``core.tiling.halo_from_offsets`` computes
    from a raw stage list."""
    out = []
    for op in program.applies():
        lo = [0] * program.d
        hi = [0] * program.d
        for off in op.offsets:
            for i, o in enumerate(off):
                lo[i] = max(lo[i], -int(o))
                hi[i] = max(hi[i], int(o))
        out.append(tuple((l, h) for l, h in zip(lo, hi)))
    return out


def suffix_halos(program: Program) -> list[tuple[tuple[int, int], ...]]:
    """Per-apply *input* halos in program order — how far past the domain
    each apply's operand must extend, i.e. the halo of everything
    downstream of that apply.  For a linear chain this equals the legacy
    ``core.tiling.stage_suffix_halos`` entries (pinned by test)."""
    halos = infer_halos(program)
    out = []
    for op in program.applies():
        # The apply's *result* halo is what downstream still needs — the
        # legacy suffix convention (last stage's entry is all-zero).
        box = halos.get(op.result)
        if box is None:
            raise ValueError(f"apply {op.result!r} is dead (never consumed)")
        out.append(tuple(box))
    return out
