"""Plan schema: frozen, JSON-serializable artifacts of the plan compiler.

A :class:`StencilPlan` is the single source of truth for how one stencil
computation is executed: how the grid is padded (paper §6), which tile the
sweep kernels use, which axis they sweep, how many stages one launch
fuses, and what the Hopper cost model predicts for that choice (device
bytes and modelled time).  Plans are pure data — tuples, ints, floats,
strings — so they serialize to JSON losslessly and hash stably across
process restarts (the :class:`~repro_torch.plan.cache.PlanCache` key).

A copy of the JAX package's ``plan/schema`` with its wire format: a plan
the reference serialised loads here (its fields the port lacks take their
defaults).  The port's request adds ``hardware``, the card's description
(:class:`~repro_torch.core.tiling.HopperDevice`), which enters the cache
key; its plan adds the time model's fields.

Schema versioning: bump :data:`PLANNER_VERSION` whenever the planning
pipeline changes in a way that should invalidate cached plans; the version
participates in the cache key, so stale on-disk plans are simply never hit
again.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass
from typing import Sequence

import numpy as np

from ..core.tiling import H100_SXM, SMEM_BLOCK_LIMIT, HopperDevice

__all__ = [
    "PLANNER_VERSION",
    "PlanMismatchError",
    "PlanRequest",
    "LatticeReport",
    "PadPlan",
    "StageSpec",
    "StencilPlan",
    "validate_plan_call",
]

# v7: the quantized compute path (DESIGN.md §15) — stage dtypes now
# include int8 (``StageSpec.dtype="int8"``: 1-byte frontiers/handoffs,
# f32 MACs), and the §15 boundary menu grew periodic and robin kinds,
# both of which reach request ``bcs`` and change the lowered launch.
# Quantization *parameters* (scale, zero point) are execution knobs —
# they scale stored codes, never geometry — so they stay out of the
# key, exactly like stage weights.  The tuner also races window_kind ×
# stage-dtype variants now (advisory rows in the v2 TuneDB), so v6
# measured winners are invalidated wholesale rather than mis-compared.
# Stage dtypes that restate the chain input's dtype None-normalize at
# ``PlanRequest.make`` (an f32 chain spelled ["bf16", "f32"] keys the
# same as ["bf16", None]), matching the launch's derivation.
# (v6: ring windows + mixed precision (DESIGN.md §14) — every request
# carried ``window_kind`` (``auto``/``ring``/``trapezoid``: how staged
# frontiers are sized) and every :class:`StageSpec` an optional output
# ``dtype`` (``None`` = the chain input's); plans record the chosen
# ``window_kind``.)
# (v5: the stencil-program IR (DESIGN.md §13) — every request now carries
# ``program``, the canonical weightless serialized stencil program its
# stages/offsets lower from (derived, never user-passed, so the
# ``time_steps=``/``stages=``/explicit-program spellings of one
# computation share a key), plus ``bcs``, the per-stage boundary
# conditions a boundary-op program declares.)
# (v4: multi-core column sharding — ``num_shards``/``mesh_axis`` joined
# the request and the plan gained the shard decomposition (``shard_axis``,
# worst-shard ``per_shard_traffic_bytes``, ``halo_exchange_bytes``).)
# (v3: stage chains — the request canonicalizes every temporal chain into
# an ordered ``stages`` list, and the plan grew the streaming-vs-recompute
# flop fields plus the per-depth score table.)
# (v2: temporal blocking — ``time_steps`` joined the request and the plan
# gained ``fused_depth``/``single_pass_traffic_bytes``.)
# v8 (the port): the Hopper cost model — the score is modelled time on
# the card, the request carries the card's description (``hardware``) and
# ``vmem_budget`` is shared memory per CTA.
PLANNER_VERSION = 8

# Frontier window layouts a request may ask for (DESIGN.md §14); "auto"
# lets the planner race both and keep the modeled winner.
_WINDOW_KINDS = ("auto", "ring", "trapezoid")

# Default budget: the dynamic shared memory one CTA may use on an H100.
_DEFAULT_VMEM_BUDGET = SMEM_BLOCK_LIMIT


def _int_tuple(xs) -> tuple[int, ...]:
    return tuple(int(x) for x in xs)


# Chain-input dtype name by element width — the inverse of the engine's
# dtype table for the widths a request's ``dtype_bytes`` can carry.  Used
# to None-normalize stage dtypes that merely restate the input dtype.
_ITEMSIZE_NAME = {1: "int8", 2: "bfloat16", 4: "float32", 8: "float64"}


def _dtype_name(dt) -> str | None:
    """Canonical dtype name, validated against the engine's dtype table
    (``core.tiling``) — numpy-free bfloat16 handling included."""
    if dt is None:
        return None
    from ..core.tiling import dtype_itemsize

    if not isinstance(dt, str):
        # numpy scalar types and dtypes collapse through np.dtype; a torch
        # dtype prints as "torch.<name>".
        try:
            dt = np.dtype(dt).name
        except TypeError:
            pass
    name = str(getattr(dt, "name", dt)).removeprefix("torch.")
    dtype_itemsize(name)  # raises ValueError on unsupported names
    return name


def _offsets_tuple(offsets, d: int):
    """Canonicalize per-RHS offset groups to nested int tuples."""
    groups = []
    for g in offsets:
        arr = np.asarray(g, dtype=np.int64).reshape(-1, d)
        groups.append(tuple(_int_tuple(row) for row in arr))
    return tuple(groups)


def _bcs_tuple(bcs, n_stages: int):
    """Canonicalize per-stage boundary conditions: each entry ``None`` /
    ``"zero"`` / ``(kind, value)``; an all-native chain collapses to the
    empty tuple so bc-free requests keep their bc-free key."""
    from ..ir.ops import normalize_bc

    if not bcs:
        return ()
    norm = []
    for bc in bcs:
        if bc is None or isinstance(bc, str):
            norm.append(normalize_bc(bc))
        else:
            kind, value = bc
            norm.append(normalize_bc(kind, value))
    if len(norm) != n_stages:
        raise ValueError(
            f"{len(norm)} boundary conditions for {n_stages} stage(s)"
        )
    if all(bc is None for bc in norm):
        return ()
    return tuple(norm)


def _derive_program(d: int, offs, specs, bcs) -> str:
    """The request's canonical serialized stencil program (DESIGN.md §13):
    weightless, values canonically renamed — always derived, never
    user-passed, so every spelling of one computation shares a key."""
    from ..ir.ops import plan_program_key

    if specs:
        return plan_program_key(
            d, stage_offsets=[st.offsets for st in specs],
            bcs=bcs if bcs else None,
        )
    return plan_program_key(d, rhs_offsets=list(offs))


def _hardware(hw) -> tuple:
    """The canonical ``hardware`` tuple of a request."""
    if hw is None or (not isinstance(hw, HopperDevice) and not len(hw)):
        return H100_SXM.key()
    if isinstance(hw, HopperDevice):
        return hw.key()
    return HopperDevice.from_key(hw).key()


@dataclass(frozen=True)
class StageSpec:
    """One stage of a stage-chain program: a single stencil operator.

    ``offsets`` is the canonical (s, d) offset tuple of this stage's
    operator; ``weights`` are optional — the planner's decisions (halo,
    window, traffic, flops) depend only on the offsets, so kernel-driven
    requests leave weights ``None`` to keep cache keys weight-independent,
    while explicit requests may carry them for the record.  ``dtype`` is
    the stage *output*'s canonical dtype name (DESIGN.md §14; ``None`` =
    the chain input's) — unlike weights it changes the shared-memory
    and traffic model, so it is part of the cache key.
    """

    offsets: tuple[tuple[int, ...], ...]
    weights: tuple[float, ...] | None = None
    dtype: str | None = None

    @classmethod
    def make(cls, spec, d: int) -> "StageSpec":
        """Canonicalize one stage spec: a :class:`StageSpec`, a
        ``{"offsets": ..., "weights": ..., "dtype": ...}`` dict, an
        ``(offsets, weights)`` pair, or a bare (s, d) offset array."""
        dtype = None
        if isinstance(spec, StageSpec):
            offsets, weights, dtype = spec.offsets, spec.weights, spec.dtype
        elif isinstance(spec, dict):
            offsets, weights = spec["offsets"], spec.get("weights")
            dtype = spec.get("dtype")
        else:
            # An (offsets, weights) pair is distinguished from a bare
            # offset array by its first element being a 2-D offset table.
            is_pair = False
            if isinstance(spec, (tuple, list)) and len(spec) == 2:
                try:
                    is_pair = np.asarray(spec[0], dtype=np.int64).ndim == 2
                except (ValueError, TypeError):
                    is_pair = False
            if is_pair:
                offsets, weights = spec
            else:
                offsets, weights = spec, None
        offs = _offsets_tuple([offsets], d)[0]
        if weights is not None:
            weights = tuple(float(w) for w in weights)
            if len(weights) != len(offs):
                raise ValueError(
                    f"stage has {len(offs)} offsets but {len(weights)} weights"
                )
        return cls(offsets=offs, weights=weights, dtype=_dtype_name(dtype))

    @classmethod
    def from_dict(cls, d: dict) -> "StageSpec":
        return cls(
            offsets=tuple(_int_tuple(o) for o in d["offsets"]),
            weights=(
                tuple(float(w) for w in d["weights"])
                if d.get("weights") is not None
                else None
            ),
            dtype=_dtype_name(d.get("dtype")),
        )


@dataclass(frozen=True)
class PlanRequest:
    """Canonical inputs of one planning problem (the cache key's preimage).

    ``offsets`` is a tuple of per-RHS offset groups, matching
    ``multi_stencil_pallas``'s ``offsets_list`` (a single-array stencil is a
    1-tuple).  ``geometry`` is an ``(a, z, w)`` hardware-cache model for the
    paper's steps 1-3 (unfavorable-grid detection + padding); ``None``
    skips them: the kernels' windows sit in explicitly managed shared
    memory, and the pad stage is a no-op.

    ``stages`` is the ordered stage-chain program (DESIGN.md §9): one
    :class:`StageSpec` per application, with ``time_steps ==
    len(stages)``.  A single-operator ``time_steps=T`` request is
    canonicalized to T repeated stages, so the old spelling and the
    explicit-chain spelling of the same computation share one cache key.
    Multi-RHS requests (``len(offsets) > 1``) cannot chain and carry an
    empty ``stages``.

    ``num_shards``/``mesh_axis`` (DESIGN.md §10) ask for the column-
    sharded launch over a ``num_shards``-device mesh axis.  Sharding
    never changes the tile decision (the decomposition is per-column),
    so a ``num_shards=1`` request is *the same request* — same canonical
    dict, same cache key — as one that never mentions sharding.

    ``program`` (DESIGN.md §13) is the canonical weightless serialized
    stencil program this request lowers from — **always derived** from
    the stages/offsets (+ ``bcs``), never user-passed, so the
    ``time_steps=``/``stages=``/explicit-program spellings of one
    computation share a single cache key.  ``bcs`` carries the per-stage
    boundary conditions a boundary-op program declares (``None`` = the
    engine-native zero fill; an all-native chain collapses to ``()``).

    ``window_kind`` (DESIGN.md §14) asks for a frontier window layout:
    ``"ring"`` keeps each staged intermediate at its steady-state band,
    ``"trapezoid"`` at the full warm-up cone, ``"auto"`` (the default)
    lets the planner race both and keep the modeled winner.  Per-stage
    output dtypes live on the :class:`StageSpec`\\ s (``dtypes=`` in
    :meth:`make`); ``dtype_bytes`` stays the *input* element width.

    In the port, ``vmem_budget`` is the shared memory one CTA may use
    (default :data:`~repro_torch.core.tiling.SMEM_BLOCK_LIMIT`), whole:
    ``n_operands`` is kept for the wire format and splits nothing, since
    the kernels stage no output tile.  ``geometry`` models a
    hardware-managed cache for the paper's steps 1-3 (the H100's L2 set
    mapping is not documented, so it is an input, never a guess).
    ``hardware`` is the card's description
    (:meth:`HopperDevice.key <repro_torch.core.tiling.HopperDevice.key>`;
    default :data:`~repro_torch.core.tiling.H100_SXM`); it is part of the
    cache key, so plans made for one card are never served on another.
    """

    shape: tuple[int, ...]
    offsets: tuple[tuple[tuple[int, ...], ...], ...]
    dtype_bytes: int = 4
    vmem_budget: int = _DEFAULT_VMEM_BUDGET
    n_operands: int = 2
    geometry: tuple[int, int, int] | None = None
    aligned: bool = True
    pipelined: bool = True
    strategy: str = "paper"
    max_pad: int = 16
    time_steps: int = 1
    stages: tuple[StageSpec, ...] = ()
    num_shards: int = 1
    mesh_axis: str = "columns"
    bcs: tuple = ()
    program: str = ""
    window_kind: str = "auto"
    hardware: tuple = H100_SXM.key()

    @classmethod
    def make(
        cls,
        shape: Sequence[int],
        offsets=None,
        dtype_bytes: int = 4,
        vmem_budget: int | None = None,
        n_operands: int | None = None,
        geometry: Sequence[int] | None = None,
        aligned: bool = True,
        pipelined: bool = True,
        strategy: str = "paper",
        max_pad: int = 16,
        time_steps: int = 1,
        stages: Sequence | None = None,
        num_shards: int = 1,
        mesh_axis: str = "columns",
        bcs: Sequence | None = None,
        dtypes: Sequence | None = None,
        window_kind: str = "auto",
        hardware=None,
    ) -> "PlanRequest":
        """Build a canonical request.  ``offsets`` may be a single (s, d)
        offset array or a sequence of per-RHS arrays.  ``stages`` instead
        gives the ordered stage chain (each entry a :class:`StageSpec`,
        ``(offsets, weights)`` pair, dict, or bare offset array); it is
        mutually exclusive with ``offsets``+``time_steps``.  ``bcs``
        gives each stage input's boundary condition (``None``/``"zero"``/
        ``(kind, value)``); ``dtypes`` each stage's output dtype (§14;
        ``None`` entries = the input's, stored on the stage specs);
        ``window_kind`` the frontier layout (``auto``/``ring``/
        ``trapezoid``); ``hardware`` the card (a
        :class:`~repro_torch.core.tiling.HopperDevice` or its ``key()``;
        default the published H100 SXM figures); ``program`` is always
        derived, never accepted."""
        shape = _int_tuple(shape)
        d = len(shape)
        window_kind = str(window_kind)
        if window_kind not in _WINDOW_KINDS:
            raise ValueError(
                f"window_kind must be one of {_WINDOW_KINDS}, "
                f"got {window_kind!r}"
            )
        if stages is not None:
            if offsets is not None:
                raise ValueError("pass offsets or stages, not both")
            specs = tuple(StageSpec.make(s, d) for s in stages)
            if not specs:
                raise ValueError("stages must contain at least one stage")
            if int(time_steps) not in (1, len(specs)):
                raise ValueError(
                    f"time_steps={time_steps} contradicts {len(specs)} stages"
                )
            offs = (specs[0].offsets,)
            time_steps = len(specs)
        else:
            if offsets is None:
                raise ValueError("pass offsets or stages")
            try:
                arr = np.asarray(offsets, dtype=np.int64)
            except (ValueError, TypeError):
                arr = None  # ragged: per-RHS groups of different sizes
            if arr is not None and arr.ndim == 2:
                groups = [arr]  # one RHS: a single (s, d) offset array
            elif arr is not None and arr.ndim == 3:
                groups = list(arr)  # p RHS groups of equal size
            else:
                groups = list(offsets)
            offs = _offsets_tuple(groups, d)
            time_steps = int(time_steps)
            if time_steps < 1:
                raise ValueError(f"time_steps must be >= 1, got {time_steps}")
            if time_steps > 1 and len(offs) != 1:
                # q = Σ_p K_p u_p has no well-defined iterate: which operand
                # would receive the intermediate result?
                raise ValueError(
                    "temporal fusion (time_steps > 1) requires a single RHS; "
                    f"got {len(offs)} offset groups"
                )
            # Canonical stage chain: a single-RHS request IS a (possibly
            # repeated) chain; multi-RHS requests cannot chain.
            if len(offs) == 1:
                specs = (StageSpec(offsets=offs[0]),) * time_steps
            else:
                specs = ()
        if len(specs) > 1 and len(offs) != 1:
            raise ValueError(
                "stage chains (len(stages) > 1) require a single RHS; "
                f"got {len(offs)} offset groups"
            )
        if dtypes is not None:
            if not specs:
                raise ValueError(
                    "dtypes= requires a stage chain; multi-RHS requests "
                    "run at the input dtype"
                )
            names = tuple(_dtype_name(dt) for dt in dtypes)
            if len(names) != len(specs):
                raise ValueError(
                    f"{len(names)} dtypes for {len(specs)} stage(s)"
                )
            # A stage at the chain's input dtype is the same request as no
            # dtype — normalize to None so spelling the input dtype out
            # ("float32" on an f32 chain) keys and validates identically
            # to omitting it (the launch derives the same None form).
            in_name = _ITEMSIZE_NAME.get(int(dtype_bytes))
            names = tuple(
                None if nm == in_name else nm for nm in names
            )
            specs = tuple(
                StageSpec(offsets=st.offsets, weights=st.weights, dtype=nm)
                for st, nm in zip(specs, names)
            )
        num_shards = int(num_shards)
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if num_shards > 1 and sum(1 for n in shape if n > 1) < 2:
            # Needs one axis to partition AND a distinct axis to sweep;
            # rejecting here keeps the failure mode a clear request error,
            # not a misleading downstream no-tile-fits-budget one.
            raise ValueError(
                "column sharding partitions a cross axis: grid "
                f"{shape} has fewer than 2 non-unit dims "
                f"(num_shards={num_shards})"
            )
        if n_operands is None:
            n_operands = len(offs) + 1  # p inputs + the output tile (§5)
        if geometry is not None:
            geometry = _int_tuple(geometry)
            assert len(geometry) == 3, "geometry is (a, z, w)"
        if vmem_budget is None:
            vmem_budget = _DEFAULT_VMEM_BUDGET
        norm_bcs = _bcs_tuple(bcs, len(specs))
        if norm_bcs and not specs:
            raise ValueError(
                "boundary conditions require a stage chain; multi-RHS "
                "requests run on the engine-native zero fill"
            )
        return cls(
            shape=shape,
            offsets=offs,
            dtype_bytes=int(dtype_bytes),
            vmem_budget=int(vmem_budget),
            n_operands=int(n_operands),
            geometry=geometry,
            aligned=bool(aligned),
            pipelined=bool(pipelined),
            strategy=str(strategy),
            max_pad=int(max_pad),
            time_steps=int(time_steps),
            stages=specs,
            num_shards=num_shards,
            mesh_axis=str(mesh_axis),
            bcs=norm_bcs,
            program=_derive_program(d, offs, specs, norm_bcs),
            window_kind=window_kind,
            hardware=_hardware(hardware),
        )

    def canonical(self) -> dict:
        d = asdict(self)
        d["version"] = PLANNER_VERSION
        # mesh_axis only names the mesh axis in reports — it never
        # influences the decomposition, so it stays out of the cache key
        # (requests differing only in the axis name share one plan).
        d.pop("mesh_axis")
        return d

    def cache_key(self) -> str:
        """Stable content hash of the request (+ planner version), worked
        out once a request (the request is frozen): a traced call names
        its plan's key in every span."""
        key = self.__dict__.get("_cache_key")
        if key is None:
            blob = json.dumps(self.canonical(), sort_keys=True,
                              separators=(",", ":"))
            key = hashlib.sha256(blob.encode()).hexdigest()
            self.__dict__["_cache_key"] = key
        return key

    @classmethod
    def from_dict(cls, d: dict) -> "PlanRequest":
        offs = tuple(tuple(_int_tuple(o) for o in g) for g in d["offsets"])
        time_steps = int(d.get("time_steps", 1))
        if d.get("stages") is not None:
            stages = tuple(StageSpec.from_dict(s) for s in d["stages"])
        elif len(offs) == 1:
            # v1/v2 dicts predate the stages field: derive the canonical
            # repeated chain (their cache keys are stale either way).
            stages = (StageSpec(offsets=offs[0]),) * time_steps
        else:
            stages = ()
        bcs = _bcs_tuple(d.get("bcs") or (), len(stages))
        return cls(
            shape=_int_tuple(d["shape"]),
            offsets=offs,
            dtype_bytes=int(d["dtype_bytes"]),
            vmem_budget=int(d["vmem_budget"]),
            n_operands=int(d["n_operands"]),
            geometry=_int_tuple(d["geometry"]) if d.get("geometry") else None,
            aligned=bool(d["aligned"]),
            pipelined=bool(d["pipelined"]),
            strategy=str(d["strategy"]),
            max_pad=int(d["max_pad"]),
            time_steps=time_steps,
            stages=stages,
            num_shards=int(d.get("num_shards", 1)),
            mesh_axis=str(d.get("mesh_axis", "columns")),
            bcs=bcs,
            # Re-derived, never trusted from the dict: a hand-edited or
            # pre-v5 ``program`` string cannot diverge from the stages.
            program=_derive_program(len(d["shape"]), offs, stages, bcs),
            window_kind=str(d.get("window_kind", "auto")),
            # A reference plan names no card: the published H100 figures.
            hardware=_hardware(d.get("hardware")),
        )


@dataclass(frozen=True)
class LatticeReport:
    """Diagnostics of the grid's interference lattice (paper §4/§6)."""

    S: int                                   # cache size in words
    basis: tuple[tuple[int, ...], ...]       # Eq. 9 basis, rows = vectors
    reduced: tuple[tuple[int, ...], ...]     # LLL-reduced basis
    shortest: tuple[int, ...]                # shortest vector (L1 norm)
    shortest_l1: float
    shortest_l2: float
    eccentricity: float                      # Eq. 11 of the reduced basis
    diameter: int                            # stencil diameter (2r+1 for star)
    threshold: float                         # §6: diameter / associativity
    unfavorable: bool                        # shortest_l1 < threshold
    hyperbola_k: int                         # Fig. 5 fit n1·n2 ≈ k·S/2
    hyperbola_dist: float                    # relative distance to that fit

    @classmethod
    def from_dict(cls, d: dict) -> "LatticeReport":
        return cls(
            S=int(d["S"]),
            basis=tuple(_int_tuple(r) for r in d["basis"]),
            reduced=tuple(_int_tuple(r) for r in d["reduced"]),
            shortest=_int_tuple(d["shortest"]),
            shortest_l1=float(d["shortest_l1"]),
            shortest_l2=float(d["shortest_l2"]),
            eccentricity=float(d["eccentricity"]),
            diameter=int(d["diameter"]),
            threshold=float(d["threshold"]),
            unfavorable=bool(d["unfavorable"]),
            hyperbola_k=int(d["hyperbola_k"]),
            hyperbola_dist=float(d["hyperbola_dist"]),
        )


@dataclass(frozen=True)
class PadPlan:
    """Minimal padding that makes the grid favorable (paper §6, App. B)."""

    pad: tuple[int, ...]                     # per-dim extra extent
    padded_shape: tuple[int, ...]
    extra_words: int
    shortest_before: float
    shortest_after: float
    threshold: float
    reason: str

    @property
    def nonzero(self) -> bool:
        return any(self.pad)

    @classmethod
    def zero(cls, shape: Sequence[int], shortest: float = float("inf"),
             threshold: float = 0.0, reason: str = "") -> "PadPlan":
        shape = _int_tuple(shape)
        return cls(
            pad=(0,) * len(shape),
            padded_shape=shape,
            extra_words=0,
            shortest_before=shortest,
            shortest_after=shortest,
            threshold=threshold,
            reason=reason,
        )

    @classmethod
    def from_dict(cls, d: dict) -> "PadPlan":
        return cls(
            pad=_int_tuple(d["pad"]),
            padded_shape=_int_tuple(d["padded_shape"]),
            extra_words=int(d["extra_words"]),
            shortest_before=float(d["shortest_before"]),
            shortest_after=float(d["shortest_after"]),
            threshold=float(d["threshold"]),
            reason=str(d["reason"]),
        )


@dataclass(frozen=True)
class StencilPlan:
    """The frozen output of the plan compiler — everything a consumer needs.

    ``tile``/``sweep_axis``/``pipelined`` drive the sweep engine
    (``kernels.stencil``); ``pad`` drives allocation on hardware-cache
    targets; the traffic fields record the §4 model's prediction and its
    position between the legacy heuristic and the isoperimetric lower
    bound.

    Temporal blocking (DESIGN.md §8): ``time_steps`` is the requested
    number of applications, ``fused_depth`` how many of them one kernel
    launch fuses (1 = plain single-pass; the engine runs
    ``ceil(time_steps / fused_depth)`` launches).  ``traffic_bytes`` and
    ``legacy_traffic_bytes`` always price the *whole* ``time_steps``-long
    chain, and ``single_pass_traffic_bytes`` records what the planner's own
    best depth-1 choice would have cost — the fused plan is only ever
    emitted when it wins that comparison.

    Stage chains + streaming frontiers (DESIGN.md §9): ``modeled_flops``
    prices the executed streaming-frontier kernel for the whole chain,
    ``recompute_flops`` what the §8 recompute trapezoid would have cost at
    identical traffic — their ratio is the flops the streaming path gives
    back.  ``depth_scores`` is the planner's per-depth score table,
    ``(depth, chain traffic bytes, chain streaming flops)`` rows for every
    feasible fusion depth (the row with ``depth == fused_depth`` won).

    Column sharding (DESIGN.md §10): ``num_shards`` echoes the request,
    ``shard_axis`` is the partitioned axis (``None`` when unsharded), and
    ``halo_exchange_bytes`` the total cross-device bytes the boundary
    exchange moves.  A sharded request is planned as the *worst shard's
    column slab* — the per-core cache-fitting problem, with the sweep
    constrained off the shard axis — so for ``num_shards > 1`` every
    traffic/flop field (and the legacy/single-pass baselines they gate
    against) is per-shard; ``per_shard_traffic_bytes`` names that figure
    explicitly.  ``grid`` stays the global launch grid.  A 1-shard plan
    is byte-identical to an unsharded plan.

    The port's fields: ``vmem_bytes`` holds the card's counterpart of the
    TPU window, the shared bytes per CTA of the plan's first launch;
    ``modeled_ms`` is the whole chain's modelled time on the request's
    card (:func:`repro_torch.core.tiling.launch_model`), which decided
    tile, axis, depth and window kind; ``kernel`` is the first launch's
    sweep kernel (``"apply"`` or ``"chain"``), ``ctas_per_sm`` and
    ``waves`` its residency and its columns over SMs × CTAs per SM;
    ``depth_ms`` the modelled chain time per feasible depth, and
    ``legacy_modeled_ms``/``single_pass_modeled_ms`` the baselines'
    (never below ``modeled_ms``).  A reference plan has none of them and
    loads with zeros.
    """

    request: PlanRequest
    lattice: LatticeReport | None
    pad: PadPlan
    tile: tuple[int, ...]
    sweep_axis: int | None
    grid: tuple[int, ...]
    pipelined: bool
    traffic_bytes: int
    vmem_bytes: int
    surface_to_volume: float
    lower_bound_bytes: float
    efficiency: float                        # lower_bound / traffic, ≤ 1
    legacy_tile: tuple[int, ...]
    legacy_sweep_axis: int | None
    legacy_traffic_bytes: int
    time_steps: int = 1
    fused_depth: int = 1
    single_pass_traffic_bytes: int = 0       # 0 only in legacy v1 dicts
    modeled_flops: int = 0                   # streaming-frontier chain flops
    recompute_flops: int = 0                 # §8 recompute-trapezoid flops
    depth_scores: tuple[tuple[int, int, int], ...] = ()
    num_shards: int = 1
    shard_axis: int | None = None            # partitioned cross axis (§10)
    per_shard_traffic_bytes: int = 0         # worst shard's chain traffic
    halo_exchange_bytes: int = 0             # cross-device boundary bytes
    window_kind: str = "trapezoid"           # chosen frontier layout (§14)
    version: int = PLANNER_VERSION
    modeled_ms: float = 0.0                  # whole chain, modelled time
    kernel: str = ""                         # first launch's sweep kernel
    ctas_per_sm: int = 0
    waves: float = 0.0
    depth_ms: tuple[tuple[int, float], ...] = ()
    legacy_modeled_ms: float = 0.0
    single_pass_modeled_ms: float = 0.0

    @property
    def traffic_vs_legacy(self) -> float:
        """Planned / legacy modeled traffic — ≤ 1 by construction."""
        return self.traffic_bytes / max(self.legacy_traffic_bytes, 1)

    @property
    def traffic_vs_single_pass(self) -> float:
        """Fused / own-single-pass modeled traffic — ≤ 1 by construction
        (depth 1 is always in the planner's candidate set)."""
        return self.traffic_bytes / max(self.single_pass_traffic_bytes, 1)

    @property
    def flops_vs_recompute(self) -> float:
        """Streaming / recompute modeled flops — ≤ 1 by construction (the
        streaming kernel computes a subset of the recompute extents)."""
        return self.modeled_flops / max(self.recompute_flops, 1)

    def to_dict(self) -> dict:
        return asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "StencilPlan":
        return cls(
            request=PlanRequest.from_dict(d["request"]),
            lattice=(
                LatticeReport.from_dict(d["lattice"]) if d.get("lattice") else None
            ),
            pad=PadPlan.from_dict(d["pad"]),
            tile=_int_tuple(d["tile"]),
            sweep_axis=None if d["sweep_axis"] is None else int(d["sweep_axis"]),
            grid=_int_tuple(d["grid"]),
            pipelined=bool(d["pipelined"]),
            traffic_bytes=int(d["traffic_bytes"]),
            vmem_bytes=int(d["vmem_bytes"]),
            surface_to_volume=float(d["surface_to_volume"]),
            lower_bound_bytes=float(d["lower_bound_bytes"]),
            efficiency=float(d["efficiency"]),
            legacy_tile=_int_tuple(d["legacy_tile"]),
            legacy_sweep_axis=(
                None if d["legacy_sweep_axis"] is None
                else int(d["legacy_sweep_axis"])
            ),
            legacy_traffic_bytes=int(d["legacy_traffic_bytes"]),
            time_steps=int(d.get("time_steps", 1)),
            fused_depth=int(d.get("fused_depth", 1)),
            single_pass_traffic_bytes=int(
                d.get("single_pass_traffic_bytes", d["traffic_bytes"])
            ),
            modeled_flops=int(d.get("modeled_flops", 0)),
            recompute_flops=int(d.get("recompute_flops", 0)),
            depth_scores=tuple(
                (int(r[0]), int(r[1]), int(r[2]))
                for r in d.get("depth_scores", ())
            ),
            num_shards=int(d.get("num_shards", 1)),
            shard_axis=(
                None if d.get("shard_axis") is None else int(d["shard_axis"])
            ),
            per_shard_traffic_bytes=int(
                d.get("per_shard_traffic_bytes", d["traffic_bytes"])
            ),
            halo_exchange_bytes=int(d.get("halo_exchange_bytes", 0)),
            # Pre-v6 plans never sized a ring; their frontiers were cones.
            window_kind=str(d.get("window_kind", "trapezoid")),
            version=int(d.get("version", PLANNER_VERSION)),
            modeled_ms=float(d.get("modeled_ms", 0.0)),
            kernel=str(d.get("kernel", "")),
            ctas_per_sm=int(d.get("ctas_per_sm", 0)),
            waves=float(d.get("waves", 0.0)),
            depth_ms=tuple(
                (int(r[0]), float(r[1])) for r in d.get("depth_ms", ())
            ),
            legacy_modeled_ms=float(d.get("legacy_modeled_ms", 0.0)),
            single_pass_modeled_ms=float(d.get("single_pass_modeled_ms", 0.0)),
        )

    @classmethod
    def from_json(cls, s: str) -> "StencilPlan":
        return cls.from_dict(json.loads(s))


class PlanMismatchError(ValueError):
    """A precompiled plan was applied to a call it was not compiled for.

    Executing such a plan silently mis-tiles (wrong tile/sweep for the
    actual shape) or under-allocates the shared-memory window (halo
    computed from different offsets), so the kernel frontends refuse it
    loudly instead.
    """


def validate_plan_call(
    plan: StencilPlan,
    shape: Sequence[int],
    offsets,
    dtype_bytes: int,
    time_steps: int = 1,
    stages: Sequence | None = None,
    bcs: Sequence | None = None,
    dtypes: Sequence | None = None,
) -> None:
    """Raise :class:`PlanMismatchError` unless ``plan`` was compiled for
    exactly this call: same grid shape, same canonicalized offset groups,
    same element width, same requested step count, and — when the call
    runs a stage chain — the same per-stage operator offsets, boundary
    conditions, and output dtypes (a boundary op or a bf16 stage changes
    the computed values, so a plan for the zero-fill f32 program is not a
    plan for the neumann or mixed-precision one).

    Budget/strategy knobs are deliberately *not* checked — a plan compiled
    under a custom shared-memory budget is still a valid (if different) answer for
    the same computation; shape/offsets/dtype/time_steps/stages are what
    change the computation itself.  Per-stage *weights* are also not
    checked: they scale values, never the halo geometry the plan encodes.
    ``num_shards`` is likewise an execution knob (§10 sharding is
    bit-wise invariant), so a sharded plan may be executed on any shard
    count — callers override with ``num_shards=``/``mesh=`` at the call.
    """
    req = plan.request
    shape = _int_tuple(shape)
    offs = _offsets_tuple(offsets, len(shape))
    mismatches = []
    if req.shape != shape:
        mismatches.append(f"shape: plan {req.shape} vs call {shape}")
    if req.offsets != offs:
        mismatches.append(
            f"offsets: plan has {len(req.offsets)} group(s) "
            f"{req.offsets} vs call {offs}"
        )
    if req.dtype_bytes != int(dtype_bytes):
        mismatches.append(
            f"dtype_bytes: plan {req.dtype_bytes} vs call {int(dtype_bytes)}"
        )
    if req.time_steps != int(time_steps):
        mismatches.append(
            f"time_steps: plan {req.time_steps} vs call {int(time_steps)}"
        )
    if stages is not None:
        call_stages = tuple(
            StageSpec.make(s, len(shape)).offsets for s in stages
        )
        plan_stages = tuple(st.offsets for st in req.stages)
        if plan_stages != call_stages:
            mismatches.append(
                f"stages: plan has {len(plan_stages)} stage(s) "
                f"{plan_stages} vs call {call_stages}"
            )
    call_bcs = _bcs_tuple(
        bcs or (), len(stages) if stages is not None else int(time_steps)
    )
    if req.bcs != call_bcs:
        mismatches.append(f"bcs: plan {req.bcs} vs call {call_bcs}")
    if req.stages:
        plan_dts = tuple(st.dtype for st in req.stages)
        in_name = _ITEMSIZE_NAME.get(int(dtype_bytes))
        call_dts = (
            tuple(
                None if (nm := _dtype_name(dt)) == in_name else nm
                for dt in dtypes
            )
            if dtypes is not None
            else (None,) * len(req.stages)
        )
        if plan_dts != call_dts:
            mismatches.append(
                f"stage dtypes: plan {plan_dts} vs call {call_dts}"
            )
    if mismatches:
        raise PlanMismatchError(
            "StencilPlan does not match this call (plan request key "
            f"{req.cache_key()[:16]}…): " + "; ".join(mismatches)
        )
