"""Host side of the port's stencil launch path.

``stencil_pallas`` / ``stencil_iterate`` / ``ir.run_program`` →
:func:`multi_stencil_pallas` → ``ir.lower`` → :func:`_stencil_call` →
:func:`embed_inputs` → :func:`_padded_call` → the two sweep kernels of
:mod:`repro_torch.kernels.sweep`: ``sweep_apply`` for one application over
p RHS arrays, ``sweep_chain`` for a fused chain of T >= 2 stages.

The frontends keep the JAX package's names and signatures for what this
slice supports — an explicit ``tile=`` and ``sweep_axis=``, ``pipelined``,
``time_steps``, ``stages``, ``program`` and ``window_kind`` — at zero fill
with every stage stored at the input dtype (f32 or bf16).  Every other
argument raises ``NotImplementedError`` naming the ``ROADMAP.md`` item that
brings it.  Every spelling lowers through the port's stencil-program IR,
as the reference does, so the launches equal the reference's.

The entry points run on the card: ``device=None`` means ``"cuda"``, and
``device="cpu"`` runs each kernel's plain PyTorch version (the tests).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import ir, resolve_device
from ..core.tiling import chain_halo, halo_from_offsets, stage_suffix_halos
from .sweep import sweep_apply, sweep_chain

__all__ = [
    "stencil_pallas",
    "multi_stencil_pallas",
    "stencil_iterate",
    "halo_from_offsets",
]


def _round_up(n: int, t: int) -> int:
    return -(-n // t) * t


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the port yet: ROADMAP.md queue A, {item}"
    )


_PLANNER = "item 8 (Hopper cost model and planner)"
_BOUNDARY = "item 4 (boundary correction taps B5 and periodic wrap)"
_DTYPES = "item 5 (per-stage storage dtypes)"
_QUANT = "item 6 (int8-quantized frontiers B6)"
_TUNE = "item 9 (measured tune loop)"
_OBS = "item 10 (telemetry)"
_SHARD = "item 11 (column sharding)"


class _Stage(NamedTuple):
    """Static per-stage geometry of a fused chain (python ints/arrays).

    ``lo``/``hi`` are this stage's own per-dim halo; ``suffix_lo``/
    ``suffix_hi`` the per-dim sums over the *later* stages; ``ext`` the
    stage's computed extent ``tile + suffix_lo + suffix_hi`` (the final
    stage's ``ext`` is the bare tile).  The reference's ``bc``, ``dtype``
    and ``quant`` fields come with the slices that use them."""

    offsets: object                 # (s, d) int array
    weights: tuple
    lo: tuple
    hi: tuple
    suffix_lo: tuple
    suffix_hi: tuple
    ext: tuple


def _launch_geometry(offsets_w, stages_w, tile):
    """Static launch geometry: per-RHS offset/weight arrays, the per-stage
    chain (``None`` = single application), and the window cone
    ``lo_w``/``hi_w`` — the reference's ``_launch_geometry`` at zero fill
    and the input dtype."""
    d = len(tile)
    if stages_w is not None:
        T = len(stages_w)
        st_offs = [np.asarray(s[0], dtype=np.int64).reshape(-1, d)
                   for s in stages_w]
        st_wts = [tuple(float(w) for w in s[1]) for s in stages_w]
        st_halos = [halo_from_offsets([o], d) for o in st_offs]
        cone = chain_halo(st_halos)
        lo_w = tuple(lo for lo, _ in cone)
        hi_w = tuple(hi for _, hi in cone)
        suffix = stage_suffix_halos(st_halos)
        stages = []
        for j in range(T):
            sfx_lo = tuple(lo for lo, _ in suffix[j])
            sfx_hi = tuple(hi for _, hi in suffix[j])
            stages.append(_Stage(
                offsets=st_offs[j],
                weights=st_wts[j],
                lo=tuple(h[0] for h in st_halos[j]),
                hi=tuple(h[1] for h in st_halos[j]),
                suffix_lo=sfx_lo,
                suffix_hi=sfx_hi,
                ext=tuple(
                    t + l + h for t, l, h in zip(tile, sfx_lo, sfx_hi)
                ),
            ))
        stages = tuple(stages)
        offsets = [st_offs[0]]
        weights = [list(st_wts[0])]
    else:
        stages = None
        offsets = [np.asarray(ow[0], dtype=np.int64).reshape(-1, d)
                   for ow in offsets_w]
        weights = [list(ow[1]) for ow in offsets_w]
        halo = halo_from_offsets(offsets, d)
        lo_w = tuple(h[0] for h in halo)
        hi_w = tuple(h[1] for h in halo)
    return offsets, weights, stages, lo_w, hi_w


def _padded_call(ins, dom, offsets, weights, stages, lo_w, hi_w, tile,
                 sweep, pipelined, n_true, window_kind="ring"):
    """Run a sweep kernel over already-padded buffers and return the
    *padded* result (``∏ ntiles_i · tile_i`` per dim, no trim).

    ``ins`` carry the window halo on every dim (``lo_w_i + k_i·tile_i +
    hi_w_i``); ``dom`` is the ``(d,)`` true-grid coordinate of local
    element 0 (zeros on one card) and ``n_true`` the unpadded grid shape,
    which keep a chain's intermediate-stage masks global."""
    if stages is None:
        return sweep_apply(ins, offsets, weights, lo_w, hi_w, tile, sweep,
                           pipelined)
    return sweep_chain(ins[0], stages, lo_w, hi_w, tile, sweep, pipelined,
                       window_kind, n_true=tuple(int(n) for n in n_true),
                       dom=tuple(int(v) for v in dom))


def embed_inputs(us, pads):
    """Zero-extend each tensor into its launch buffer: per-dim ``(lo,
    hi)`` extra extent, content at offset ``lo``, zeros elsewhere — the
    reference's ``pad_free=False`` form (the pad-free, periodic-wrap and
    quantized-fill forms come with their slices)."""
    bufs = []
    for u in us:
        shape = tuple(int(n) + lo + hi for (lo, hi), n in zip(pads, u.shape))
        buf = torch.zeros(shape, dtype=u.dtype, device=u.device)
        buf[tuple(slice(lo, lo + int(n)) for (lo, _), n in zip(pads, u.shape))] = u
        bufs.append(buf)
    return bufs


def _launch_inputs(us, offsets_w, tile, stages_w=None):
    """The padded launch buffers and static geometry of one launch:
    ``(ins, offsets, weights, stages, lo_w, hi_w)``.  Each buffer carries
    the lo halo on the low side and the hi halo plus the round-up to the
    tile on the high side."""
    offsets, weights, stages, lo_w, hi_w = _launch_geometry(
        offsets_w, stages_w, tile
    )
    pads = [
        (l, h + _round_up(int(n), t) - int(n))
        for l, h, n, t in zip(lo_w, hi_w, us[0].shape, tile)
    ]
    return embed_inputs(us, pads), offsets, weights, stages, lo_w, hi_w


def _stencil_call(us, offsets_w, tile, sweep, pipelined, stages_w=None,
                  window_kind="ring"):
    """us: tuple of p same-shape tensors.  offsets_w: tuple per tensor of
    (offsets_tuple, weights_tuple).  ``stages_w`` (tuple per stage of
    (offsets_tuple, weights_tuple), single RHS only) fuses the whole
    chain into this one launch."""
    u0 = us[0]
    d = u0.ndim
    tile = tuple(int(t) for t in tile)
    ins, offsets, weights, stages, lo_w, hi_w = _launch_inputs(
        us, offsets_w, tile, stages_w
    )
    out = _padded_call(
        ins, (0,) * d, offsets, weights, stages, lo_w, hi_w, tile, sweep,
        pipelined, tuple(u0.shape), window_kind=window_kind,
    )
    return out[tuple(slice(0, n) for n in u0.shape)].contiguous()


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    if isinstance(dt, str):
        return dt
    return np.dtype(dt).name


def _as_tensors(us, device) -> tuple[torch.Tensor, ...]:
    dev = resolve_device(device)
    out = []
    for u in us:
        t = torch.as_tensor(u)
        out.append(t.to(dev).contiguous())
    return tuple(out)


def stencil_pallas(
    u,
    offsets: np.ndarray,
    weights: Sequence[float],
    tile: Sequence[int] | None = None,
    vmem_budget: int | None = None,
    sweep_axis: int | None = None,
    pipelined: bool = True,
    plan=None,
    time_steps: int = 1,
    num_shards: int | None = None,
    shard_axis: int | None = None,
    mesh=None,
    tune=None,
    trace: str | None = None,
    dtypes: Sequence | None = None,
    window_kind: str | None = None,
    device=None,
) -> torch.Tensor:
    """Single-array weighted stencil, zero boundary fill (matches ref).

    ``time_steps=T > 1`` applies the stencil T times in one fused launch
    (explicit ``tile``).  ``device=None`` runs on the card."""
    return multi_stencil_pallas(
        [u], [offsets], [weights], tile=tile, vmem_budget=vmem_budget,
        sweep_axis=sweep_axis, pipelined=pipelined, plan=plan,
        time_steps=time_steps, num_shards=num_shards,
        shard_axis=shard_axis, mesh=mesh, tune=tune, trace=trace,
        dtypes=dtypes, window_kind=window_kind, device=device,
    )


def stencil_iterate(
    u,
    offsets: np.ndarray | None = None,
    weights: Sequence[float] | None = None,
    time_steps: int | None = None,
    tile: Sequence[int] | None = None,
    vmem_budget: int | None = None,
    sweep_axis: int | None = None,
    pipelined: bool = True,
    plan=None,
    stages: Sequence[tuple] | None = None,
    num_shards: int | None = None,
    shard_axis: int | None = None,
    mesh=None,
    tune=None,
    trace: str | None = None,
    dtypes: Sequence | None = None,
    window_kind: str | None = None,
    device=None,
) -> torch.Tensor:
    """Run a stage-chain stencil program — the iterative-solver workload.

    ``stencil_iterate(u, offsets, weights, T)`` applies one operator T
    times (Jacobi sweeps); ``stencil_iterate(u, stages=[(offsets_1,
    weights_1), ...])`` runs a distinct operator per stage (Runge-Kutta
    sub-steps, damped-Jacobi pairs).  With an explicit ``tile`` the whole
    chain is one fused launch."""
    kw = dict(
        tile=tile, vmem_budget=vmem_budget, sweep_axis=sweep_axis,
        pipelined=pipelined, plan=plan, num_shards=num_shards,
        shard_axis=shard_axis, mesh=mesh, tune=tune, trace=trace,
        dtypes=dtypes, window_kind=window_kind, device=device,
    )
    if stages is not None:
        if offsets is not None or weights is not None:
            raise ValueError("pass (offsets, weights) or stages, not both")
        if time_steps is not None and time_steps != len(stages):
            raise ValueError(
                f"time_steps={time_steps} contradicts {len(stages)} stages"
            )
        return multi_stencil_pallas([u], None, None, stages=stages, **kw)
    if offsets is None or weights is None or time_steps is None:
        raise ValueError(
            "stencil_iterate needs (offsets, weights, time_steps) or stages"
        )
    return multi_stencil_pallas(
        [u], [offsets], [weights], time_steps=time_steps, **kw
    )


def multi_stencil_pallas(
    us,
    offsets_list: Sequence[np.ndarray] | None,
    weights_list: Sequence[Sequence[float]] | None,
    tile: Sequence[int] | None = None,
    vmem_budget: int | None = None,
    sweep_axis: int | None = None,
    pipelined: bool = True,
    plan=None,
    time_steps: int = 1,
    stages: Sequence[tuple] | None = None,
    num_shards: int | None = None,
    shard_axis: int | None = None,
    mesh=None,
    tune=None,
    trace: str | None = None,
    program=None,
    dtypes: Sequence | None = None,
    window_kind: str | None = None,
    device=None,
) -> torch.Tensor:
    """p-RHS stencil ``q = Σ_p K_p u_p`` (paper §5), or a stage chain.

    Every spelling is lowered through the stencil-program IR: the
    ``offsets_list``/``stages=``/``time_steps=`` arguments build the
    equivalent :class:`repro_torch.ir.Program`, or ``program`` passes one
    (or its serialized JSON) directly, with ``us`` in
    ``program.inputs()`` order.  A chain runs as one fused launch at the
    explicit ``tile``; ``window_kind`` (``"ring"``, the default, or
    ``"trapezoid"``) picks the frontier layout and never changes the
    result.  ``device=None`` runs on the card, ``device="cpu"`` runs the
    kernels' plain versions."""
    if trace is not None:
        raise _later("trace=", _OBS)
    if tune:
        raise _later("tune=", _TUNE)
    if plan is not None:
        raise _later("plan=", _PLANNER)
    if vmem_budget is not None:
        raise _later("vmem_budget=", _PLANNER)
    if (num_shards is not None and int(num_shards) > 1) or mesh is not None \
            or shard_axis is not None:
        raise _later("num_shards=/mesh=/shard_axis=", _SHARD)
    if tile is None:
        raise _later("tile=None (planned tiles)", _PLANNER)
    if window_kind is not None and window_kind not in ("ring", "trapezoid"):
        raise ValueError(
            f"window_kind must be 'ring' or 'trapezoid', got {window_kind!r}"
        )
    us = _as_tensors(us, device)
    if len({u.shape for u in us}) != 1:
        raise ValueError("RHS arrays must share a shape")
    d = us[0].ndim
    shape = tuple(int(n) for n in us[0].shape)
    in_name = _dtype_name(us[0].dtype)
    if dtypes is not None and any(
        dt is not None and _dtype_name(dt) != in_name for dt in dtypes
    ):
        raise _later("a dtypes= entry other than the input's", _DTYPES)
    # -- build the stencil program -----------------------------------------
    if program is not None:
        if (offsets_list is not None or weights_list is not None
                or stages is not None):
            raise ValueError(
                "pass program= or the (offsets/weights/stages) spellings, "
                "not both"
            )
        if dtypes is not None:
            raise ValueError(
                "dtypes= belongs to the legacy spellings; a program "
                "carries per-stage dtypes on its apply ops"
            )
        prog = (
            ir.Program.from_json(program) if isinstance(program, str)
            else program
        )
    elif stages is not None:
        if offsets_list is not None or weights_list is not None:
            raise ValueError(
                "pass (offsets_list, weights_list) or stages, not both"
            )
        if len(us) != 1:
            raise ValueError(
                f"stage chains require a single RHS; got {len(us)} arrays"
            )
        if not tuple(stages):
            raise ValueError("stages must contain at least one stage")
        for o, ws in stages:
            offs = np.asarray(o, dtype=np.int64).reshape(-1, d)
            if len(offs) != len(tuple(ws)):
                raise ValueError(
                    f"stage has {len(offs)} offsets but {len(tuple(ws))} "
                    "weights"
                )
        prog = ir.chain_program(list(stages), d)
    else:
        T = int(time_steps)
        if T < 1:
            raise ValueError(f"time_steps must be >= 1, got {T}")
        if T > 1 and len(us) != 1:
            raise ValueError(
                "temporal fusion (time_steps > 1) requires a single RHS; "
                f"got {len(us)} arrays"
            )
        if len(us) == 1:
            prog = ir.stencil_program(
                offsets_list[0], weights_list[0], time_steps=T, d=d,
            )
        else:
            prog = ir.rhs_program(offsets_list, weights_list, d=d)
    # -- verify + lower onto the engine's launch form ----------------------
    lowered = ir.lower(prog, shape)
    tile = tuple(int(t) for t in tile)
    sweep_axis = 0 if sweep_axis is None else int(sweep_axis)
    window_kind = window_kind or "ring"
    pipelined = bool(pipelined)

    def static_spec(op):
        offs, wts = op
        return (tuple(map(tuple, np.asarray(offs).tolist())),
                tuple(float(w) for w in wts))

    if lowered.kind == "chain":
        if len(us) != 1:
            raise ValueError(
                f"program lowers to a stage chain over one input; got "
                f"{len(us)} arrays"
            )
        if lowered.has_bc:
            raise _later("a non-zero boundary", _BOUNDARY)
        if any(q is not None for q in lowered.quants):
            raise _later("a quantized stage", _QUANT)
        if any(dt is not None and dt != in_name for dt in lowered.dtypes):
            raise _later("a stage dtype other than the input's", _DTYPES)
        chain = [static_spec(op) for op in lowered.stages]
        if len(chain) == 1:
            return _stencil_call(us, (chain[0],), tile, sweep_axis,
                                 pipelined)
        return _stencil_call(
            us, (chain[0],), tile, sweep_axis, pipelined,
            stages_w=tuple(chain), window_kind=window_kind,
        )
    # multi-RHS single application: ``us`` arrives in load order; stage p
    # applies to lowered.inputs[p].
    if len(us) != len(lowered.inputs):
        raise ValueError(
            f"program loads {len(lowered.inputs)} inputs; got "
            f"{len(us)} arrays"
        )
    load_order = {name: i for i, name in enumerate(prog.inputs())}
    us = tuple(us[load_order[name]] for name in lowered.inputs)
    offsets_w = tuple(static_spec(op) for op in lowered.stages)
    return _stencil_call(us, offsets_w, tile, sweep_axis, pipelined)
