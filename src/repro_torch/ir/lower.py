"""Lowering: stencil programs → the sweep engine's launch form.

The engine (DESIGN.md §8/§9) executes two shapes:

* a **chain** — T stages applied back-to-back to one input through the
  trapezoid VMEM window, and
* a **multi-RHS** launch — ``q = Σ_p K_p u_p`` over distinct inputs.

Lowering linearizes a program into one of these.  It deliberately never
*composes* stencils algebraically: a composed operator is mathematically
equal to the chain but not bit-wise equal (different summation order,
different boundary masking), and bit-parity with the legacy
``stages=``/``time_steps=`` paths is the contract.  The only folding
performed is exact: a ``combine`` whose operands are (applies of) one
shared predecessor merges into a single stage with a widened offset
table — ``(1-ω)·u + ω·K·u`` is *the same* weighted sum either way.

Boundary annotations survive lowering as per-stage ``(kind, value)``
entries; the chain kernel turns them into in-kernel correction taps
(:mod:`repro_torch.kernels.sweep`), so no host-side pad materializes.
"""

from __future__ import annotations

from dataclasses import dataclass

from .ops import (
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
from .verify import verify

__all__ = ["IRLowerError", "Lowered", "lower", "run_program"]


class IRLowerError(ValueError):
    """The program is valid IR but has no engine launch form."""


@dataclass(frozen=True)
class Lowered:
    """The engine launch form of a program.

    ``kind`` is ``"chain"`` (stages applied in order to ``inputs[0]``)
    or ``"multi_rhs"`` (``stages[p]`` applied to ``inputs[p]`` and
    summed).  ``stages`` holds ``(offsets, weights)`` pairs; ``bcs``
    holds each stage input's normalized boundary (``None`` = engine-
    native zero fill), ``dtypes`` each stage *output*'s storage dtype
    name (``None`` = the chain input's; DESIGN.md §14), and ``quants``
    each stage output's affine int8 ``(scale, zero_point)`` (``None`` =
    unquantized; DESIGN.md §15) — all always the same length as
    ``stages``.
    """

    kind: str
    inputs: tuple[str, ...]
    stages: tuple[tuple[tuple[tuple[int, ...], ...], tuple[float, ...]], ...]
    bcs: tuple
    dtypes: tuple = ()
    quants: tuple = ()

    @property
    def has_bc(self) -> bool:
        return any(bc is not None for bc in self.bcs)


@dataclass(frozen=True)
class _Chain:
    """Linearization state: ``stages`` applied to loaded ``input``; ``bc``
    is the pending boundary annotation on the chain's current value."""

    input: str
    stages: tuple  # ((offsets, weights, in_bc, dtype, quant), ...)
    bc: tuple | None = None


def _merge_taps(taps):
    """Sum weights of duplicate offsets, preserving first-seen order."""
    table: dict[tuple, float] = {}
    order = []
    for off, w in taps:
        if off not in table:
            table[off] = 0.0
            order.append(off)
        table[off] += float(w)
    return tuple(order), tuple(table[o] for o in order)


def lower(program: Program, shape=None) -> Lowered:
    """Verify ``program`` and linearize it to a :class:`Lowered` launch
    form; raises :class:`IRLowerError` when no engine shape fits."""
    verify(program, shape)
    d = program.d
    env: dict[str, _Chain] = {}
    multi: dict[str, Lowered] = {}
    deq: set[str] = set()
    result: Lowered | None = None

    for op in program.ops:
        if isinstance(op, Load):
            env[op.result] = _Chain(input=op.input, stages=())
        elif isinstance(op, Boundary):
            src = env.get(op.operand)
            if src is None:
                raise IRLowerError(
                    f"boundary {op.result!r} annotates a multi-RHS value"
                )
            env[op.result] = _Chain(
                input=src.input, stages=src.stages,
                bc=normalize_bc(op.kind, op.value),
            )
        elif isinstance(op, Apply):
            if op.weights is None:
                raise IRLowerError(
                    f"apply {op.result!r} has no weights — shape-only "
                    "programs plan but do not lower to a launch"
                )
            src = env.get(op.operand)
            if src is None:
                raise IRLowerError(
                    f"apply {op.result!r} consumes a multi-RHS value; the "
                    "engine cannot chain stages after a multi-RHS combine"
                )
            env[op.result] = _Chain(
                input=src.input,
                stages=src.stages
                + ((op.offsets, op.weights, src.bc, op.dtype, None),),
            )
        elif isinstance(op, Quantize):
            # Collapse apply → quantize into the producing stage: int8
            # frontier storage with the (scale, zero_point) attached.
            # verify guarantees the operand is an apply result, so the
            # chain is non-empty and carries no pending boundary.
            src = env.get(op.operand)
            if src is None:
                raise IRLowerError(
                    f"quantize {op.result!r} consumes a multi-RHS value"
                )
            *head, (offs, wts, in_bc, dt, qn) = src.stages
            assert qn is None  # verify: operand is an apply, not a quantize
            if dt is not None and dt != "int8":
                raise IRLowerError(
                    f"quantize {op.result!r}: stage declares dtype {dt!r} "
                    "— a quantized stage stores int8"
                )
            env[op.result] = _Chain(
                input=src.input,
                stages=tuple(head) + (
                    (offs, wts, in_bc, "int8",
                     (float(op.scale), int(op.zero_point))),
                ),
            )
        elif isinstance(op, Dequantize):
            # Storage-only: the engine dequantizes implicitly when the
            # next stage's MACs read the int8 frontier, so the chain
            # state passes through unchanged.
            env[op.result] = env[op.operand]
            deq.add(op.result)
        elif isinstance(op, Combine):
            folded = _fold_combine(op, env, d)
            if folded is not None:
                env[op.result] = folded
            else:
                multi[op.result] = _as_multi_rhs(op, env)
        elif isinstance(op, Store):
            if op.operand in multi:
                result = multi[op.operand]
            else:
                if op.operand in deq:
                    raise IRLowerError(
                        "stored value is a dequantize result — the launch "
                        "output keeps its storage dtype; store the "
                        "quantize result and dequantize host-side, or "
                        "drop the quantization on the final stage"
                    )
                src = env[op.operand]
                if not src.stages:
                    raise IRLowerError(
                        "stored value is a bare load — the program "
                        "computes no stencil"
                    )
                if src.bc is not None:
                    raise IRLowerError(
                        "stored value carries an unconsumed boundary "
                        "annotation (boundaries condition stage *inputs*)"
                    )
                result = Lowered(
                    kind="chain",
                    inputs=(src.input,),
                    stages=tuple(
                        (offs, wts) for offs, wts, _, _, _ in src.stages
                    ),
                    bcs=tuple(bc for _, _, bc, _, _ in src.stages),
                    dtypes=tuple(dt for _, _, _, dt, _ in src.stages),
                    quants=tuple(qn for _, _, _, _, qn in src.stages),
                )
    assert result is not None  # verify guarantees exactly one store
    return result


def _fold_combine(op: Combine, env: dict[str, _Chain], d: int):
    """Try the exact single-stage fold: every operand is the shared
    predecessor itself (an identity tap) or one apply away from it.
    Returns the folded :class:`_Chain`, or ``None`` if the operands do
    not share a predecessor (multi-RHS candidates)."""
    prefix: tuple | None = None  # (input, stage-tuple) of the shared pred
    taps = []
    bcs = set()
    dts: set = set()  # folded-stage output dtypes must agree
    for name, coeff in zip(op.operands, op.coeffs):
        src = env.get(name)
        if src is None:
            return None
        if src.stages:
            # Peel the last stage: its apply site is the fold candidate.
            *head, (offs, wts, in_bc, dt, qn) = src.stages
            key = (src.input, tuple(head))
            if src.bc is not None:
                # A boundary on an apply *result* used in a combine has
                # no single-stage fold form.
                return None
            if qn is not None:
                # A coefficient-scaled quantized value is not the
                # quantization of anything the fold could spell.
                return None
            cand = [(o, float(coeff) * float(w)) for o, w in zip(offs, wts)]
            bcs.add(in_bc)
            dts.add(dt)
        else:
            # The predecessor itself: identity tap.  Offset 0 never
            # exits the domain, so its boundary annotation is inert.
            key = (src.input, ())
            cand = [((0,) * d, float(coeff))]
        if prefix is None:
            prefix = key
        elif prefix != key:
            return None
        taps.extend(cand)
    # Identity-only combines (no apply operand) fold trivially but carry
    # no bc; with apply operands, all their input bcs — and output
    # dtypes — must agree (summing a bf16-rounded value with an f32 one
    # is not a single weighted application of anything).
    if len(bcs) > 1 or len(dts) > 1:
        return None
    bc = next(iter(bcs)) if bcs else None
    dt = next(iter(dts)) if dts else None
    offsets, weights = _merge_taps(taps)
    assert prefix is not None
    return _Chain(
        input=prefix[0],
        stages=tuple(prefix[1]) + ((offsets, weights, bc, dt, None),),
    )


def _as_multi_rhs(op: Combine, env: dict[str, _Chain]) -> Lowered:
    """The §5 multi-RHS form: each operand exactly one (zero-boundary)
    apply over a distinct load, coefficients folded into the weights."""
    inputs = []
    stages = []
    for name, coeff in zip(op.operands, op.coeffs):
        src = env.get(name)
        if src is None:
            raise IRLowerError(
                f"combine {op.result!r}: operand {name!r} is itself a "
                "multi-RHS value; nested combines do not lower"
            )
        if len(src.stages) != 1:
            raise IRLowerError(
                f"combine {op.result!r}: operand {name!r} is "
                f"{len(src.stages)} applies deep — a multi-RHS combine "
                "needs exactly one apply per operand (and operands of a "
                "foldable combine must share one predecessor)"
            )
        offs, wts, in_bc, dt, qn = src.stages[0]
        if in_bc is not None or src.bc is not None:
            raise IRLowerError(
                f"combine {op.result!r}: operand {name!r} carries a "
                "non-zero boundary — the multi-RHS launch supports only "
                "the engine-native zero fill"
            )
        if dt is not None or qn is not None:
            raise IRLowerError(
                f"combine {op.result!r}: operand {name!r} declares a "
                "stage dtype or quantization — the multi-RHS launch runs "
                "at the input dtype only"
            )
        if src.input in inputs:
            raise IRLowerError(
                f"combine {op.result!r}: input {src.input!r} feeds two "
                "operands — same-input applies should fold; spell the "
                "combine over one predecessor instead"
            )
        inputs.append(src.input)
        stages.append((offs, tuple(float(coeff) * float(w) for w in wts)))
    return Lowered(
        kind="multi_rhs",
        inputs=tuple(inputs),
        stages=tuple(stages),
        bcs=(None,) * len(stages),
        quants=(None,) * len(stages),
    )


def run_program(program: Program, arrays, **kwargs):
    """Execute ``program`` on the sweep engine.

    ``arrays`` maps the program's load names to tensors (a single
    tensor or positional sequence also works, matched to
    ``program.inputs()`` order).  Extra keyword arguments (``tile=``,
    ``sweep_axis=``, ``window_kind=``, ``device=``...) pass through to
    :func:`repro_torch.kernels.stencil.multi_stencil_pallas`.
    """
    from ..kernels.stencil import multi_stencil_pallas  # lazy: torch

    names = program.inputs()
    if isinstance(arrays, dict):
        missing = [n for n in names if n not in arrays]
        if missing:
            raise KeyError(f"program inputs missing from arrays: {missing}")
        us = [arrays[n] for n in names]
    elif isinstance(arrays, (list, tuple)):
        if len(arrays) != len(names):
            raise ValueError(
                f"{len(arrays)} arrays for {len(names)} program inputs"
            )
        us = list(arrays)
    else:
        us = [arrays] * len(names)
    return multi_stencil_pallas(us, None, None, program=program, **kwargs)
