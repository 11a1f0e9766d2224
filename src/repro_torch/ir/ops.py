"""Stencil-program IR: ops and per-value bounds (DESIGN.md §13).

A :class:`Program` is an ordered list of SSA ops over named values:

* ``load``     — bring one external grid array into the program;
* ``apply``    — one weighted stencil application (offsets + weights);
* ``combine``  — a linear combination ``Σ_k c_k · v_k`` of earlier values;
* ``boundary`` — declare how reads past the true domain of a value
  resolve (``zero`` / ``dirichlet`` / ``neumann`` / ``reflect``);
* ``store``    — mark one value as the program's result.

Every value carries per-dim :class:`Bounds` — an origin/end box in grid
coordinates, xdsl-stencil style (``lb`` may be negative: the value is
needed ``-lb_i`` cells *before* the domain starts) — assigned by the
shape-inference pass (:mod:`repro_torch.ir.infer`), which propagates
accessed-offset footprints backward from the ``store``.  The legality
pass lives in :mod:`repro_torch.ir.verify`, the lowering onto the sweep
engine's launch form in :mod:`repro_torch.ir.lower`.

This module is numpy-only and a copy of the JAX package's IR ops: the
serialized form is the wire format both packages read and write.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

__all__ = [
    "BC_KINDS",
    "Apply",
    "Boundary",
    "Bounds",
    "Combine",
    "Dequantize",
    "Load",
    "Program",
    "Quantize",
    "Store",
    "chain_program",
    "normalize_bc",
    "plan_program_key",
    "rhs_program",
    "stencil_program",
    "summarize_program",
]

# Boundary kinds the IR admits.  ``zero`` is the engine's native fill;
# ``dirichlet`` reads a constant; ``neumann`` edge-replicates (the
# zero-normal-derivative discretization, numpy's pad mode "edge");
# ``reflect`` mirrors about the boundary node (numpy's mode "reflect":
# u[-e] = u[e], u[N-1+e] = u[N-1-e]); ``periodic`` wraps reads around
# the torus (numpy's mode "wrap": u[-e] = u[N-e]); ``robin`` fills the
# ghost cells with an affine mix of the edge value,
# ``u_ghost = α·u_edge + β`` (α=0 degenerates to dirichlet(β), α=1,β=0
# to neumann — ``normalize_bc`` canonicalizes those spellings).
BC_KINDS = ("zero", "dirichlet", "neumann", "reflect", "periodic", "robin")


def _int_tuple(xs) -> tuple[int, ...]:
    return tuple(int(x) for x in xs)


def _offsets_tuple(offsets, d: int | None = None):
    arr = np.asarray(offsets, dtype=np.int64)
    if arr.ndim == 1:
        arr = arr.reshape(1, -1)
    if d is not None:
        arr = arr.reshape(-1, d)
    return tuple(_int_tuple(row) for row in arr)


def normalize_bc(kind: str | None, value=0.0):
    """Canonical boundary annotation: ``None`` for the engine-native zero
    fill (``zero``, or ``dirichlet`` with value 0 — bit-identical by
    construction: every correction term carries a factor of the constant),
    else ``(kind, value)`` with the value floated.

    ``robin`` takes a 2-sequence value ``(alpha, beta)`` (the ghost fill
    ``α·u_edge + β``) and canonicalizes its degenerate corners: α=0 is
    dirichlet(β), α=1 with β=0 is neumann.  ``periodic`` carries no
    value."""
    if kind is None or kind == "zero":
        return None
    if kind == "robin":
        if not isinstance(value, (tuple, list)) or len(value) != 2:
            raise ValueError(
                f"robin boundary wants value=(alpha, beta), got {value!r}"
            )
        alpha, beta = float(value[0]), float(value[1])
        if alpha == 0.0:
            return normalize_bc("dirichlet", beta)
        if alpha == 1.0 and beta == 0.0:
            return ("neumann", 0.0)
        return ("robin", (alpha, beta))
    if kind == "periodic":
        return ("periodic", 0.0)
    if kind == "dirichlet" and float(value) == 0.0:
        return None
    return (str(kind), float(value))


@dataclass(frozen=True)
class Bounds:
    """Per-dim origin/end box of one value, in grid coordinates.

    ``lb`` is inclusive, ``ub`` exclusive — the value covers
    ``[lb_i, ub_i)`` per dim, xdsl-stencil style.  The stored result has
    ``lb = 0, ub = shape``; upstream values grow by the accessed-offset
    footprints (their *halo* is ``lo_i = -lb_i``, ``hi_i = ub_i - N_i``).
    """

    lb: tuple[int, ...]
    ub: tuple[int, ...]

    def __post_init__(self):
        assert len(self.lb) == len(self.ub), (self.lb, self.ub)

    @property
    def extent(self) -> tuple[int, ...]:
        return tuple(u - l for l, u in zip(self.lb, self.ub))

    def union(self, other: "Bounds") -> "Bounds":
        return Bounds(
            lb=tuple(min(a, b) for a, b in zip(self.lb, other.lb)),
            ub=tuple(max(a, b) for a, b in zip(self.ub, other.ub)),
        )

    def grown(self, offsets: Sequence[Sequence[int]]) -> "Bounds":
        """The operand box an ``apply`` with these offsets needs to cover
        this result box: grow each side by the accessed-offset reach."""
        offs = np.asarray(offsets, dtype=np.int64).reshape(-1, len(self.lb))
        lo = offs.min(axis=0)
        hi = offs.max(axis=0)
        return Bounds(
            lb=tuple(int(l + min(0, int(o))) for l, o in zip(self.lb, lo)),
            ub=tuple(int(u + max(0, int(o))) for u, o in zip(self.ub, hi)),
        )

    def halo(self, shape: Sequence[int]) -> tuple[tuple[int, int], ...]:
        """Per-dim ``(lo, hi)`` reach past the ``[0, N)`` domain."""
        return tuple(
            (max(0, -l), max(0, u - int(n)))
            for l, u, n in zip(self.lb, self.ub, shape)
        )

    def to_dict(self) -> dict:
        return {"lb": list(self.lb), "ub": list(self.ub)}

    def __str__(self) -> str:  # the xdsl rendering: ([lb] : [ub])
        return f"([{', '.join(map(str, self.lb))}] : [{', '.join(map(str, self.ub))}])"


@dataclass(frozen=True)
class Load:
    """Bring external array ``input`` into the program as value ``result``."""

    result: str
    input: str

    def to_dict(self) -> dict:
        return {"op": "load", "result": self.result, "input": self.input}


@dataclass(frozen=True)
class Apply:
    """One weighted stencil application of ``operand``.

    ``weights`` may be ``None`` for a *shape-only* program (the plan
    compiler's cache key is weight-independent, mirroring
    ``plan.schema.StageSpec``); such a program plans but cannot lower to
    an executable launch.

    ``dtype`` declares the result's storage dtype by canonical name
    (``None`` = the chain input's dtype): the engine stores this value's
    frontier / write-back at that width while still accumulating in f32
    (DESIGN.md §14).  Like weights it is a value attribute, not part of
    the canonical plan-key structure — ``plan.schema.StageSpec.dtype``
    carries it into the request.
    """

    result: str
    operand: str
    offsets: tuple[tuple[int, ...], ...]
    weights: tuple[float, ...] | None = None
    dtype: str | None = None

    def to_dict(self) -> dict:
        d: dict = {
            "op": "apply",
            "result": self.result,
            "operand": self.operand,
            "offsets": [list(o) for o in self.offsets],
        }
        if self.weights is not None:
            d["weights"] = [float(w) for w in self.weights]
        if self.dtype is not None:
            d["dtype"] = str(self.dtype)
        return d


@dataclass(frozen=True)
class Combine:
    """Linear combination ``result = Σ_k coeffs_k · operands_k``."""

    result: str
    operands: tuple[str, ...]
    coeffs: tuple[float, ...]

    def to_dict(self) -> dict:
        return {
            "op": "combine",
            "result": self.result,
            "operands": list(self.operands),
            "coeffs": [float(c) for c in self.coeffs],
        }


@dataclass(frozen=True)
class Boundary:
    """Declare the boundary condition of ``operand``: subsequent reads of
    ``result`` past the true domain resolve per ``kind`` instead of the
    engine-native zero fill.

    ``value`` is the Dirichlet constant, or for ``robin`` the
    ``(alpha, beta)`` pair of the ghost fill ``α·u_edge + β``."""

    result: str
    operand: str
    kind: str
    value: float | tuple[float, float] = 0.0

    def to_dict(self) -> dict:
        d: dict = {
            "op": "boundary",
            "result": self.result,
            "operand": self.operand,
            "kind": self.kind,
        }
        if self.kind == "dirichlet":
            d["value"] = float(self.value)
        elif self.kind == "robin":
            d["value"] = [float(v) for v in self.value]
        return d


@dataclass(frozen=True)
class Quantize:
    """Affine int8 quantization of ``operand`` (DESIGN.md §15):

        ``q = clip(round(x / scale) + zero_point, -128, 127)`` (int8)

    with ``round`` the IEEE half-even rounding (``jnp.round``), so the
    mapping is deterministic across backends.  The zero point is an
    *integer* in int8 range, so exact zeros (the engine's domain-mask
    fill) survive the round-trip bit-exactly:
    ``round(0/s) + zp = zp`` dequantizes back to ``0.0``.

    Lowering collapses ``apply → quantize`` into int8 frontier storage
    with f32 MACs — like ``Apply.dtype``, the scale/zero-point are
    execution parameters, not part of the canonical plan-key structure.
    """

    result: str
    operand: str
    scale: float
    zero_point: int = 0

    def to_dict(self) -> dict:
        return {
            "op": "quantize",
            "result": self.result,
            "operand": self.operand,
            "scale": float(self.scale),
            "zero_point": int(self.zero_point),
        }


@dataclass(frozen=True)
class Dequantize:
    """Inverse of :class:`Quantize`: ``x = (q - zero_point) · scale``
    back to f32.  Its operand must be a ``quantize`` result with matching
    parameters (the IR's quantization is storage-only — verify rejects
    anything else), so lowering passes it through: the engine dequantizes
    implicitly when the next stage's MACs read the int8 frontier."""

    result: str
    operand: str
    scale: float
    zero_point: int = 0

    def to_dict(self) -> dict:
        return {
            "op": "dequantize",
            "result": self.result,
            "operand": self.operand,
            "scale": float(self.scale),
            "zero_point": int(self.zero_point),
        }


@dataclass(frozen=True)
class Store:
    """Mark ``operand`` as the program's (single) result."""

    operand: str

    def to_dict(self) -> dict:
        return {"op": "store", "operand": self.operand}


_OP_TYPES = {"load": Load, "apply": Apply, "combine": Combine,
             "boundary": Boundary, "quantize": Quantize,
             "dequantize": Dequantize, "store": Store}


def _op_from_dict(d: dict):
    kind = d.get("op")
    if kind == "load":
        return Load(result=str(d["result"]), input=str(d["input"]))
    if kind == "apply":
        return Apply(
            result=str(d["result"]),
            operand=str(d["operand"]),
            offsets=tuple(_int_tuple(o) for o in d["offsets"]),
            weights=(
                tuple(float(w) for w in d["weights"])
                if d.get("weights") is not None
                else None
            ),
            dtype=(
                str(d["dtype"]) if d.get("dtype") is not None else None
            ),
        )
    if kind == "combine":
        return Combine(
            result=str(d["result"]),
            operands=tuple(str(o) for o in d["operands"]),
            coeffs=tuple(float(c) for c in d["coeffs"]),
        )
    if kind == "boundary":
        raw = d.get("value", 0.0)
        value = (
            tuple(float(v) for v in raw)
            if isinstance(raw, (tuple, list)) else float(raw)
        )
        return Boundary(
            result=str(d["result"]),
            operand=str(d["operand"]),
            kind=str(d["kind"]),
            value=value,
        )
    if kind in ("quantize", "dequantize"):
        cls = Quantize if kind == "quantize" else Dequantize
        return cls(
            result=str(d["result"]),
            operand=str(d["operand"]),
            scale=float(d["scale"]),
            zero_point=int(d.get("zero_point", 0)),
        )
    if kind == "store":
        return Store(operand=str(d["operand"]))
    raise ValueError(f"unknown IR op {kind!r}")


@dataclass(frozen=True)
class Program:
    """An ordered, SSA stencil program over a ``d``-dimensional grid."""

    d: int
    ops: tuple

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        return {"d": int(self.d), "ops": [op.to_dict() for op in self.ops]}

    def serialize(self) -> str:
        """Canonical JSON (sorted keys, no whitespace) — the stable wire
        and cache-key form; ``Program.from_json(p.serialize())`` round-
        trips to an equal program."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_dict(cls, d: dict) -> "Program":
        return cls(d=int(d["d"]), ops=tuple(_op_from_dict(o) for o in d["ops"]))

    @classmethod
    def from_json(cls, s: str) -> "Program":
        return cls.from_dict(json.loads(s))

    # -- introspection -----------------------------------------------------

    def inputs(self) -> tuple[str, ...]:
        """External array names, in load order."""
        return tuple(op.input for op in self.ops if isinstance(op, Load))

    def applies(self) -> tuple[Apply, ...]:
        return tuple(op for op in self.ops if isinstance(op, Apply))

    def stored(self) -> str:
        for op in self.ops:
            if isinstance(op, Store):
                return op.operand
        raise ValueError("program has no store op")

    def canonical(self, keep_weights: bool = False) -> "Program":
        """The plan-key normal form: values renamed ``v0, v1, ...`` in
        definition order, zero/dirichlet(0) boundary ops dropped (they
        are bit-identical to the native fill), weights stripped unless
        ``keep_weights`` — so every spelling of the same computation
        (``time_steps=``, ``stages=``, an explicit program) serializes to
        one string."""
        rename: dict[str, str] = {}
        fresh = iter(range(len(self.ops)))
        ops = []

        def name(v: str) -> str:
            # A separate counter: aliased-through names (dropped zero
            # boundaries) must not burn a v<n> slot, or the aliased and
            # unannotated spellings would serialize differently.
            if v not in rename:
                rename[v] = f"v{next(fresh)}"
            return rename[v]

        for op in self.ops:
            if isinstance(op, Load):
                ops.append(Load(result=name(op.result), input=op.input))
            elif isinstance(op, Boundary):
                bc = normalize_bc(op.kind, op.value)
                if bc is None:
                    rename[op.result] = name(op.operand)  # alias through
                else:
                    ops.append(Boundary(
                        result=name(op.result), operand=name(op.operand),
                        kind=bc[0], value=bc[1],
                    ))
            elif isinstance(op, Apply):
                # dtype is stripped with the weights: the canonical form
                # keys the *structure*; StageSpec.dtype differentiates
                # mixed-precision requests in the plan cache.
                ops.append(Apply(
                    result=name(op.result), operand=name(op.operand),
                    offsets=op.offsets,
                    weights=op.weights if keep_weights else None,
                ))
            elif isinstance(op, Combine):
                ops.append(Combine(
                    result=name(op.result),
                    operands=tuple(name(o) for o in op.operands),
                    coeffs=op.coeffs,
                ))
            elif isinstance(op, (Quantize, Dequantize)):
                # Scale/zero-point are execution parameters, stripped
                # like weights and Apply.dtype: the canonical form keys
                # the structure only (StageSpec.dtype differentiates
                # quantized requests in the plan cache).
                rename[op.result] = name(op.operand)  # alias through
            elif isinstance(op, Store):
                ops.append(Store(operand=name(op.operand)))
            else:  # pragma: no cover - _OP_TYPES is closed
                raise ValueError(f"unknown op {op!r}")
        return Program(d=self.d, ops=tuple(ops))


# -- builders --------------------------------------------------------------


def _stage_pairs(stages, d: int):
    """Canonicalize a stage list: each entry an ``(offsets, weights)``
    pair or a bare offset array (weights ``None``)."""
    out = []
    for spec in stages:
        is_pair = False
        if isinstance(spec, (tuple, list)) and len(spec) == 2:
            try:
                is_pair = np.asarray(spec[0], dtype=np.int64).ndim == 2
            except (ValueError, TypeError):
                is_pair = False
        if is_pair:
            offs, wts = spec
            wts = tuple(float(w) for w in wts) if wts is not None else None
        else:
            offs, wts = spec, None
        out.append((_offsets_tuple(offs, d), wts))
    return out


def chain_program(
    stages: Sequence,
    d: int,
    boundary: str | Sequence | None = None,
    value: float = 0.0,
    input_name: str = "u",
    dtypes: Sequence[str | None] | None = None,
    quants: Sequence[tuple | None] | None = None,
) -> Program:
    """A linear stage chain: ``load → [boundary →] apply [→ quantize]
    → ... → store``.

    ``stages`` is an ordered list of ``(offsets, weights)`` pairs (or
    bare offset arrays for a shape-only program).  ``boundary`` declares
    each stage input's boundary condition — one kind for the whole chain
    or a per-stage sequence whose entries are a kind or a
    ``(kind, value)`` pair (``None``/``"zero"`` entries fall back to the
    native zero fill); ``value`` is the shared boundary value (the
    Dirichlet constant, or robin's ``(alpha, beta)``) for entries that
    don't carry their own.  ``dtypes`` attaches each apply's output
    storage dtype (``None`` entries = the input's; DESIGN.md §14);
    ``quants`` attaches per-stage ``(scale, zero_point)`` int8
    quantization (a :class:`Quantize` op after the apply; DESIGN.md §15).
    """
    pairs = _stage_pairs(stages, d)
    if not pairs:
        raise ValueError("chain_program needs at least one stage")
    if boundary is None or isinstance(boundary, str):
        specs: list = [(boundary, value)] * len(pairs)
    else:
        entries = list(boundary)
        if len(entries) != len(pairs):
            raise ValueError(
                f"{len(entries)} boundary kinds for {len(pairs)} stages"
            )
        specs = []
        for b in entries:
            if (isinstance(b, (tuple, list)) and len(b) == 2
                    and isinstance(b[0], str)):
                specs.append((b[0], b[1]))
            else:
                specs.append((b, value))
    if dtypes is None:
        dts: list[str | None] = [None] * len(pairs)
    else:
        dts = [str(dt) if dt is not None else None for dt in dtypes]
        if len(dts) != len(pairs):
            raise ValueError(
                f"{len(dts)} dtypes for {len(pairs)} stages"
            )
    if quants is None:
        qs: list[tuple | None] = [None] * len(pairs)
    else:
        qs = [
            (float(q[0]), int(q[1])) if q is not None else None
            for q in quants
        ]
        if len(qs) != len(pairs):
            raise ValueError(
                f"{len(qs)} quants for {len(pairs)} stages"
            )
    ops: list = [Load(result="u0", input=input_name)]
    cur = "u0"
    for j, ((offs, wts), (kind, val)) in enumerate(zip(pairs, specs)):
        if normalize_bc(kind, val) is not None or kind == "zero":
            bname = f"b{j}"
            bval = (
                tuple(float(v) for v in val)
                if isinstance(val, (tuple, list)) else float(val)
            )
            ops.append(Boundary(result=bname, operand=cur,
                                kind=str(kind), value=bval))
            cur = bname
        vname = f"v{j + 1}"
        ops.append(Apply(result=vname, operand=cur, offsets=offs,
                         weights=wts, dtype=dts[j]))
        cur = vname
        if qs[j] is not None:
            qname = f"q{j + 1}"
            ops.append(Quantize(result=qname, operand=cur,
                                scale=qs[j][0], zero_point=qs[j][1]))
            cur = qname
    ops.append(Store(operand=cur))
    return Program(d=d, ops=tuple(ops))


def stencil_program(
    offsets,
    weights=None,
    time_steps: int = 1,
    d: int | None = None,
    boundary: str | None = None,
    value: float = 0.0,
    dtypes: Sequence[str | None] | None = None,
) -> Program:
    """``time_steps`` repeated applications of one operator — the program
    form of ``stencil_pallas(time_steps=T)``."""
    arr = np.asarray(offsets, dtype=np.int64)
    if d is None:
        d = arr.shape[-1]
    wts = tuple(float(w) for w in weights) if weights is not None else None
    stage = (_offsets_tuple(arr, d), wts)
    return chain_program([stage] * int(time_steps), d,
                         boundary=boundary, value=value, dtypes=dtypes)


def rhs_program(offsets_list, weights_list=None, d: int | None = None) -> Program:
    """The §5 multi-RHS form ``q = Σ_p K_p u_p``: one load + apply per
    operand, combined with unit coefficients."""
    if d is None:
        d = int(np.asarray(offsets_list[0], dtype=np.int64).shape[-1])
    if weights_list is None:
        weights_list = [None] * len(offsets_list)
    ops: list = []
    names = []
    for p, (offs, wts) in enumerate(zip(offsets_list, weights_list)):
        ops.append(Load(result=f"u{p}", input=f"u{p}"))
        ops.append(Apply(
            result=f"a{p}", operand=f"u{p}",
            offsets=_offsets_tuple(offs, d),
            weights=tuple(float(w) for w in wts) if wts is not None else None,
        ))
        names.append(f"a{p}")
    if len(names) == 1:
        ops.append(Store(operand=names[0]))
    else:
        ops.append(Combine(result="q", operands=tuple(names),
                           coeffs=(1.0,) * len(names)))
        ops.append(Store(operand="q"))
    return Program(d=d, ops=tuple(ops))


# -- plan-key derivation ---------------------------------------------------


def plan_program_key(
    d: int,
    stage_offsets: Sequence | None = None,
    bcs: Sequence | None = None,
    rhs_offsets: Sequence | None = None,
) -> str:
    """The canonical serialized-program string a :class:`PlanRequest`
    carries (schema v5): weightless, zero-boundaries dropped, values
    canonically renamed — so the ``time_steps=``/``stages=``/program
    spellings of one computation share a single cache key.

    ``stage_offsets`` is the per-stage offset tuples of a chain request
    (with ``bcs`` the per-stage normalized boundary of each stage input);
    ``rhs_offsets`` the per-RHS offset groups of a multi-RHS request.
    """
    if rhs_offsets is not None:
        prog = rhs_program(list(rhs_offsets), d=d)
    else:
        assert stage_offsets is not None
        kinds: list[str | None] = [None] * len(stage_offsets)
        values: list = [0.0] * len(stage_offsets)
        if bcs:
            for j, bc in enumerate(bcs):
                if bc is not None:
                    # The value is already normalized (a float, or
                    # robin's (alpha, beta) tuple).
                    kinds[j], values[j] = bc[0], bc[1]
        ops: list = [Load(result="u0", input="u")]
        cur = "u0"
        for j, offs in enumerate(stage_offsets):
            if kinds[j] is not None:
                ops.append(Boundary(result=f"b{j}", operand=cur,
                                    kind=kinds[j], value=values[j]))
                cur = f"b{j}"
            ops.append(Apply(result=f"v{j + 1}", operand=cur,
                             offsets=_offsets_tuple(offs, d)))
            cur = f"v{j + 1}"
        ops.append(Store(operand=cur))
        prog = Program(d=d, ops=tuple(ops))
    return prog.canonical().serialize()


def summarize_program(program: "Program | str", shape=None) -> str:
    """One-line human rendering for spans and reports:
    ``load(u) |> boundary[neumann] |> apply[7pt r(1,1)(1,1)(1,1)] |> store``.
    """
    if isinstance(program, str):
        program = Program.from_json(program)
    parts = []
    for op in program.ops:
        if isinstance(op, Load):
            parts.append(f"load({op.input})")
        elif isinstance(op, Boundary):
            if op.kind == "dirichlet":
                detail = f"={op.value:g}"
            elif op.kind == "robin":
                detail = f"={op.value[0]:g},{op.value[1]:g}"
            else:
                detail = ""
            parts.append(f"boundary[{op.kind}{detail}]")
        elif isinstance(op, Quantize):
            parts.append(
                f"quantize[s={op.scale:g},zp={op.zero_point}]"
            )
        elif isinstance(op, Dequantize):
            parts.append("dequantize")
        elif isinstance(op, Apply):
            offs = np.asarray(op.offsets, dtype=np.int64)
            reach = "".join(
                f"({max(0, -int(offs[:, i].min(initial=0)))},"
                f"{max(0, int(offs[:, i].max(initial=0)))})"
                for i in range(program.d)
            )
            parts.append(f"apply[{len(op.offsets)}pt r{reach}]")
        elif isinstance(op, Combine):
            parts.append(f"combine[{len(op.operands)}]")
        elif isinstance(op, Store):
            parts.append("store")
    return " |> ".join(parts)
