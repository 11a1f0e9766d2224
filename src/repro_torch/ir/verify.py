"""Legality/verify pass for stencil programs (DESIGN.md §13).

Structural checks (SSA form, arities, a single ``store``, no dead
values) plus the lowering-legality constraints the correction-tap
boundary scheme imposes:

* reflect mixes interior cells back across the boundary with corrected
  offsets up to ``2e + o`` — representable in the engine's static-slice
  windows only when the stage halo is symmetric on every axis the
  boundary mixes on;
* any non-zero boundary needs ``N_i >= lo_i + hi_i + 1`` on its mixing
  axes, so one cell is never corrected by both domain edges at once.
"""

from __future__ import annotations

from typing import Sequence

from .ops import (
    BC_KINDS,
    Apply,
    Boundary,
    Combine,
    Dequantize,
    Load,
    Program,
    Quantize,
    Store,
    normalize_bc,
)

__all__ = ["IRVerifyError", "verify"]


class IRVerifyError(ValueError):
    """A stencil program failed verification."""


def _fail(msg: str):
    raise IRVerifyError(msg)


def verify(program: Program, shape: Sequence[int] | None = None) -> None:
    """Raise :class:`IRVerifyError` unless ``program`` is well-formed
    (and, when ``shape`` is given, lowerable on that domain)."""
    d = int(program.d)
    if d < 1:
        _fail(f"program dimensionality must be >= 1, got {d}")
    if shape is not None and len(shape) != d:
        _fail(f"shape {tuple(shape)} is not {d}-dimensional")

    defined: dict[str, object] = {}
    stores = []

    def define(name: str, op) -> None:
        if not name:
            _fail(f"{type(op).__name__} has an empty result name")
        if name in defined:
            _fail(f"value {name!r} defined twice (SSA violation)")
        defined[name] = op

    def use(name: str, op) -> None:
        if name not in defined:
            _fail(
                f"{type(op).__name__} reads undefined value {name!r} "
                "(operands must be defined earlier in the op list)"
            )

    for op in program.ops:
        if isinstance(op, Load):
            define(op.result, op)
        elif isinstance(op, Apply):
            use(op.operand, op)
            if not op.offsets:
                _fail(f"apply {op.result!r} has no offsets")
            for off in op.offsets:
                if len(off) != d:
                    _fail(
                        f"apply {op.result!r}: offset {off} is not "
                        f"{d}-dimensional"
                    )
            if op.weights is not None and len(op.weights) != len(op.offsets):
                _fail(
                    f"apply {op.result!r}: {len(op.weights)} weights for "
                    f"{len(op.offsets)} offsets"
                )
            define(op.result, op)
        elif isinstance(op, Combine):
            if not op.operands:
                _fail(f"combine {op.result!r} has no operands")
            if len(op.coeffs) != len(op.operands):
                _fail(
                    f"combine {op.result!r}: {len(op.coeffs)} coeffs for "
                    f"{len(op.operands)} operands"
                )
            for name in op.operands:
                use(name, op)
            define(op.result, op)
        elif isinstance(op, Boundary):
            use(op.operand, op)
            if op.kind not in BC_KINDS:
                _fail(
                    f"boundary {op.result!r}: unknown kind {op.kind!r} "
                    f"(expected one of {BC_KINDS})"
                )
            if isinstance(defined[op.operand], Boundary):
                _fail(
                    f"boundary {op.result!r} annotates another boundary "
                    f"({op.operand!r}); a value has one boundary condition"
                )
            try:
                normalize_bc(op.kind, op.value)
            except ValueError as e:
                _fail(f"boundary {op.result!r}: {e}")
            define(op.result, op)
        elif isinstance(op, Quantize):
            use(op.operand, op)
            if not float(op.scale) > 0.0:
                _fail(
                    f"quantize {op.result!r}: scale must be positive, got "
                    f"{op.scale!r}"
                )
            zp = op.zero_point
            if int(zp) != zp or not -128 <= int(zp) <= 127:
                _fail(
                    f"quantize {op.result!r}: zero_point must be an int8 "
                    f"integer in [-128, 127], got {zp!r} (an integer zero "
                    "point keeps exact zeros exact through the round-trip)"
                )
            if not isinstance(defined[op.operand], Apply):
                _fail(
                    f"quantize {op.result!r} must quantize an apply result "
                    f"(got {op.operand!r}); the IR's quantization is "
                    "storage-only — it collapses into the producing "
                    "stage's int8 frontier"
                )
            define(op.result, op)
        elif isinstance(op, Dequantize):
            use(op.operand, op)
            src = defined[op.operand]
            if not isinstance(src, Quantize):
                _fail(
                    f"dequantize {op.result!r} must consume a quantize "
                    f"result (got {op.operand!r})"
                )
            elif (float(src.scale) != float(op.scale)
                  or int(src.zero_point) != int(op.zero_point)):
                _fail(
                    f"dequantize {op.result!r}: parameters "
                    f"(scale={op.scale}, zp={op.zero_point}) do not match "
                    f"its quantize {op.operand!r} (scale={src.scale}, "
                    f"zp={src.zero_point}) — requantization is not a "
                    "storage annotation"
                )
            define(op.result, op)
        elif isinstance(op, Store):
            use(op.operand, op)
            stores.append(op)
        else:
            _fail(f"unknown op {op!r}")

    if len(stores) != 1:
        _fail(f"program must have exactly one store, got {len(stores)}")

    # Dead values: everything defined must be (transitively) consumed.
    live = {stores[0].operand}
    for op in reversed(program.ops):
        if isinstance(op, Apply) and op.result in live:
            live.add(op.operand)
        elif isinstance(op, Combine) and op.result in live:
            live.update(op.operands)
        elif isinstance(op, Boundary) and op.result in live:
            live.add(op.operand)
        elif isinstance(op, (Quantize, Dequantize)) and op.result in live:
            live.add(op.operand)
    dead = set(defined) - live
    if dead:
        _fail(f"dead values (defined but never used): {sorted(dead)}")

    # Periodic wrap is all-or-nothing across a program: the engine
    # realizes it by wrap-filling the chain input's ghost halo and
    # extending the intermediate-stage domain masks (torus translation
    # invariance makes the margin values exactly periodic) — an argument
    # that only holds when *every* stage input is periodic.  Mixing wrap
    # with masked/zero stages would feed non-periodic margins forward.
    bc_norm = {
        op.result: normalize_bc(op.kind, op.value)
        for op in program.ops if isinstance(op, Boundary)
    }
    if any(bc and bc[0] == "periodic" for bc in bc_norm.values()):
        for op in program.ops:
            if not isinstance(op, Apply):
                continue
            bc = bc_norm.get(op.operand)
            if bc is None or bc[0] != "periodic":
                _fail(
                    f"apply {op.result!r}: periodic wrap is all-or-nothing "
                    "— every stage input in a program with a periodic "
                    "boundary must be annotated periodic, but "
                    f"{op.operand!r} is not"
                )

    # Boundary lowering legality on a concrete domain.
    if shape is None:
        return
    # Map each boundary annotation to the applies that consume it.
    bc_of = {op.result: op for op in program.ops if isinstance(op, Boundary)}
    for op in program.ops:
        if not isinstance(op, Apply) or op.operand not in bc_of:
            continue
        bop = bc_of[op.operand]
        bc = normalize_bc(bop.kind, bop.value)
        if bc is None:
            continue
        kind = bc[0]
        lo = [0] * d
        hi = [0] * d
        for off in op.offsets:
            for i, o in enumerate(off):
                lo[i] = max(lo[i], -int(o))
                hi[i] = max(hi[i], int(o))
        for i in range(d):
            if lo[i] + hi[i] == 0:
                continue  # boundary never mixes on this axis
            n = int(shape[i])
            if n < lo[i] + hi[i] + 1:
                _fail(
                    f"boundary {bop.result!r} ({kind}) on axis {i}: domain "
                    f"extent {n} < {lo[i] + hi[i] + 1} — a cell would be "
                    "corrected by both edges at once"
                )
            if kind == "reflect" and lo[i] != hi[i]:
                _fail(
                    f"boundary {bop.result!r} (reflect) on axis {i}: stage "
                    f"halo ({lo[i]}, {hi[i]}) is asymmetric — reflected "
                    "taps would reach outside the engine's slice window"
                )
    # Periodic wrap additionally needs every value's demanded reach past
    # the domain to fit in one wrap (the embed fill copies each ghost
    # side from the far side once; a reach past N would need a double
    # wrap).
    if any(bc and bc[0] == "periodic" for bc in bc_norm.values()):
        from .infer import infer_halos

        halos = infer_halos(program)
        for name, bc in bc_norm.items():
            if not (bc and bc[0] == "periodic") or name not in halos:
                continue
            for i, (lo_i, hi_i) in enumerate(halos[name]):
                n = int(shape[i])
                if lo_i > n or hi_i > n:
                    _fail(
                        f"boundary {name!r} (periodic) on axis {i}: reach "
                        f"({lo_i}, {hi_i}) exceeds the domain extent {n} — "
                        "wrap fills each ghost side from the far side once"
                    )
