"""Host side of the port's stencil launch path.

``stencil_pallas`` / ``stencil_iterate`` / ``ir.run_program`` →
:func:`multi_stencil_pallas` → :func:`_resolve` (``ir.lower``, the launch
decision, the launches) → :func:`_run` → the two sweep kernels of
:mod:`repro_torch.kernels.sweep`:

* ``sweep_apply`` for one zero-fill application over p RHS arrays, handed
  the caller's tensors as they are: the kernel reads each window row
  from the grid and zero-fills what lies outside it, so such a launch
  enqueues nothing but itself (no launch buffer, no trim);
* ``sweep_chain`` for a fused chain of T >= 2 stages and for every
  launch, T = 1 included, that carries a boundary condition, a stage
  dtype other than the input's or a quantized stage: it runs on the
  padded launch buffer :func:`embed_inputs` builds (the zero or
  zero-point fill, periodic wrap bands), through :func:`_padded_call`.

The frontends keep the JAX package's names and signatures for what the
port supports — ``tile=`` (or ``None``: the planner), ``sweep_axis=``,
``plan=``, ``vmem_budget=``, ``tune=``, ``trace=``, ``pipelined``,
``time_steps``, ``stages``, ``program``, ``window_kind`` and ``dtypes`` —
with the whole boundary menu (dirichlet, neumann, reflect, robin,
periodic; per stage), f32/bf16 stage storage, int8-quantized stages and
column sharding (``num_shards=``, ``mesh=``, ``shard_axis=``:
:mod:`repro_torch.parallel.shard_columns`, bit-equal to the unsharded
launch).  Every spelling lowers through the port's stencil-program IR, as
the reference does, so the launches equal the reference's.

``tune=True`` (or an :class:`~repro_torch.plan.tune.AutoTuner`) plans an
un-tiled call by measuring: a warm ``TunedPlanDB`` hit serves the
measured winner, a miss races the planner's top candidates on the call's
device first.  ``trace="path.json"`` records the call — plan, cache
lookups, tune race and one ``kernel_launch`` span per launch with the
launch's modelled bytes, flops and ms and its frontier shared memory —
into a Chrome ``trace_event`` file (:mod:`repro_torch.obs`).  Traced or
not, each call is timed in stages (``frontend``, ``decide``, and per
launch ``launch_buffers``, ``sweep_launch`` and, after a padded launch,
``trim``) and counts the device operations it enqueues, and the launches
that read the caller's grid (``launch_buffers.direct``), into
``repro_torch.obs.totals()`` (:mod:`repro_torch.obs.stages`).

A call's launches are built once, in the ``decide`` stage: a plain
application bound by :func:`~repro_torch.kernels.sweep.bind_apply`, a
chain launch through :func:`_stencil_call`.  The call memo
(``_CALL_MEMO``, keyed by :func:`_memo_key` on every value the launches
consume, by content) keeps a resolved call whose launches are all bound
plain applications, so its repeat goes from the key straight to the run
loop (counters ``call_memo.hit`` and ``call_memo.miss``).

Without ``tile=`` the plan compiler (:mod:`repro_torch.plan`, whose
:class:`~repro_torch.plan.PlanCache` keeps plans across processes)
decides the tile, the sweep axis, the window kind and how many stages
one launch fuses, for the card the tensors are on; a chain whose fused
depth is below T runs ``ceil(T / depth)`` launches, handing each launch's
output (int8 codes for a quantized stage) to the next.  (The launch-table
cache of :mod:`repro_torch.kernels.sweep`, ``_PLANS``, is another thing:
it keeps one launch's C arrays.)

The entry points run on the card: ``device=None`` means ``"cuda"``, and
``device="cpu"`` runs each kernel's plain PyTorch version (the tests).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import ir, obs, resolve_device
from ..core.tiling import (
    H100_SXM,
    chain_halo,
    frontier_smem_bytes,
    halo_from_offsets,
    stage_suffix_halos,
)
from ..launch.mesh import ModelMesh
from ..plan import default_planner
from .sweep import bind_apply, hopper_device, sweep_apply, sweep_chain

# The call's stage timers and device-operation counters (always on;
# ``repro_torch.obs.stages``).
_FRONTEND = obs.stage("frontend")
_DECIDE = obs.stage("decide")
_BUFFERS = obs.stage("launch_buffers")
_TRIM = obs.stage("trim")
_FILL = obs.counter("device_ops.fill")
_COPY_IN = obs.counter("device_ops.copy_in")
_WRAP = obs.counter("device_ops.wrap")
_TRIM_OP = obs.counter("device_ops.trim")
_DIRECT = obs.counter("launch_buffers.direct")
_MEMO_HIT = obs.counter("call_memo.hit")
_MEMO_MISS = obs.counter("call_memo.miss")

__all__ = [
    "stencil_pallas",
    "multi_stencil_pallas",
    "stencil_iterate",
    "halo_from_offsets",
]


def _round_up(n: int, t: int) -> int:
    return -(-n // t) * t


class _Stage(NamedTuple):
    """Static per-stage geometry of a fused chain (python ints/arrays).

    ``lo``/``hi`` are this stage's own per-dim halo; ``suffix_lo``/
    ``suffix_hi`` the per-dim sums over the *later* stages; ``ext`` the
    stage's computed extent ``tile + suffix_lo + suffix_hi`` (the final
    stage's ``ext`` is the bare tile).  ``bc`` is the stage *input*'s
    boundary condition (``None`` = zero fill, else a lowered ``(kind,
    value)``), ``dtype`` the stage output's storage dtype name (``None`` =
    the launch input's) and ``quant`` its affine int8 ``(scale,
    zero_point)`` (``None`` = unquantized)."""

    offsets: object                 # (s, d) int array
    weights: tuple
    lo: tuple
    hi: tuple
    suffix_lo: tuple
    suffix_hi: tuple
    ext: tuple
    bc: tuple | None = None
    dtype: str | None = None
    quant: tuple | None = None


def _per_stage(values, T, what):
    vals = tuple(values) if values is not None else (None,) * T
    if len(vals) != T:
        raise ValueError(f"{len(vals)} {what} for {T} stages")
    return vals


def _launch_geometry(offsets_w, stages_w, tile, bcs_w=None, dtypes_w=None,
                     quants_w=None):
    """Static launch geometry: per-RHS offset/weight arrays, the per-stage
    chain (``None`` = single application), and the window cone
    ``lo_w``/``hi_w`` — the reference's ``_launch_geometry``.  ``bcs_w``,
    ``dtypes_w`` and ``quants_w`` attach each stage's lowered boundary,
    output dtype name and int8 quantization (``None`` entries: zero fill,
    the input's dtype, unquantized)."""
    d = len(tile)
    if stages_w is not None:
        T = len(stages_w)
        st_bcs = _per_stage(bcs_w, T, "boundary conditions")
        st_dts = _per_stage(dtypes_w, T, "dtypes")
        st_qns = _per_stage(quants_w, T, "quantizations")
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
                bc=st_bcs[j],
                dtype=st_dts[j],
                quant=st_qns[j],
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
                 sweep, pipelined, n_true, window_kind="ring",
                 in_quant=None):
    """Run a sweep kernel over already-padded buffers and return the
    *padded* result (``∏ ntiles_i · tile_i`` per dim, no trim), at the
    last stage's dtype.

    ``ins`` carry the window halo on every dim (``lo_w_i + k_i·tile_i +
    hi_w_i``); ``dom`` is the ``(d,)`` true-grid coordinate of local
    element 0 (zeros on one card) and ``n_true`` the unpadded grid shape,
    which keep a chain's masks and boundary corrections global.
    ``in_quant`` declares an int8 input's ``(scale, zero_point)``."""
    if stages is None:
        return sweep_apply(ins, offsets, weights, lo_w, hi_w, tile, sweep,
                           pipelined)
    return sweep_chain(ins[0], stages, lo_w, hi_w, tile, sweep, pipelined,
                       window_kind, n_true=tuple(int(n) for n in n_true),
                       dom=tuple(int(v) for v in dom), in_quant=in_quant)


def embed_inputs(us, pads, pad_free=False, wrap=None, fill=0):
    """Extend each tensor into its launch buffer: per-dim ``(lo, hi)``
    extra extent, content at offset ``lo``, ``fill`` elsewhere (the int8
    zero point of a quantized input, so its slack dequantizes to exact
    zeros).  ``pad_free`` is accepted for the reference's signature: its
    two spellings build bit-identical buffers.

    ``wrap`` (per-dim ``(lo, hi)`` ghost extents, periodic boundaries)
    fills each ghost band from the far side of the domain, axis by axis in
    the reference's order: axis k's copies read the ghost rows of axes < k
    already filled, which reproduces ``np.pad(mode="wrap")``'s corners.
    Round-up slack past the high ghost stays at ``fill``.

    Counts each device operation it enqueues (``device_ops.fill``,
    ``.copy_in``, and ``.wrap``: a band's gather and its copy)."""
    del pad_free
    bufs = []
    for u in us:
        shape = tuple(int(n) + lo + hi for (lo, hi), n in zip(pads, u.shape))
        buf = torch.full(shape, fill, dtype=u.dtype, device=u.device)
        buf[tuple(slice(lo, lo + int(n)) for (lo, _), n in zip(pads, u.shape))] = u
        obs.count(_FILL)
        obs.count(_COPY_IN)
        if wrap is not None:
            d = u.ndim
            for i, (lo, hi) in enumerate(wrap):
                n = int(u.shape[i])
                base = pads[i][0]
                for dst, src in ((slice(base - lo, base),
                                  slice(base + n - lo, base + n)),
                                 (slice(base + n, base + n + hi),
                                  slice(base, base + hi))):
                    if dst.start == dst.stop:
                        continue
                    di = [slice(None)] * d
                    si = [slice(None)] * d
                    di[i], si[i] = dst, src
                    buf[tuple(di)] = buf[tuple(si)].clone()
                    obs.count(_WRAP, 2)
        bufs.append(buf)
    return bufs


def _launch_inputs(us, offsets_w, tile, stages_w=None, bcs_w=None,
                   dtypes_w=None, quants_w=None, in_quant=None):
    """The padded launch buffers and static geometry of one launch:
    ``(ins, offsets, weights, stages, lo_w, hi_w)``.  Each buffer carries
    the lo halo on the low side and the hi halo plus the round-up to the
    tile on the high side; under periodic wrap the halos hold the far
    side's values, and an int8 input (``in_quant``) is padded with its
    zero point.  This is the call's ``launch_buffers`` stage: the
    launch's static geometry and :func:`embed_inputs`' enqueue."""
    with _BUFFERS:
        offsets, weights, stages, lo_w, hi_w = _launch_geometry(
            offsets_w, stages_w, tile, bcs_w, dtypes_w, quants_w
        )
        pads = [
            (l, h + _round_up(int(n), t) - int(n))
            for l, h, n, t in zip(lo_w, hi_w, us[0].shape, tile)
        ]
        periodic = bcs_w is not None and any(
            bc is not None and bc[0] == "periodic" for bc in bcs_w
        )
        ins = embed_inputs(
            us, pads,
            wrap=tuple(zip(lo_w, hi_w)) if periodic else None,
            fill=int(in_quant[1]) if in_quant is not None else 0,
        )
    return ins, offsets, weights, stages, lo_w, hi_w


@lru_cache(maxsize=256)
def _apply_geometry(offsets_w, tile):
    """:func:`_launch_geometry` of a plain application, kept per
    ``(offsets_w, tile)`` (tuples, as the frontend's static specs are):
    ``(offsets, weights, lo_w, hi_w)``."""
    offsets, weights, _, lo_w, hi_w = _launch_geometry(offsets_w, None, tile)
    return offsets, weights, lo_w, hi_w


def _stencil_call(us, offsets_w, tile, sweep, pipelined, stages_w=None,
                  bcs_w=None, dtypes_w=None, window_kind="ring",
                  quants_w=None, in_quant=None):
    """us: tuple of p same-shape tensors.  offsets_w: tuple per tensor of
    (offsets_tuple, weights_tuple).  ``stages_w`` (tuple per stage of
    (offsets_tuple, weights_tuple), single RHS only) fuses the whole
    chain into this one launch.  ``bcs_w`` (per stage, ``None`` or a
    lowered ``(kind, value)``), ``dtypes_w`` (per stage, ``None`` or a
    dtype name) and ``quants_w`` (per stage, ``None`` or ``(scale,
    zero_point)``) condition, store and quantize each stage; ``in_quant``
    declares the input as int8 codes of that quantization (a quantized
    hand-off from an earlier launch).  The result has the last stage's
    dtype.

    Without ``stages_w`` the launch is one zero-fill application, bound
    as :func:`_resolve` binds one (:func:`_direct` of ``bind_apply`` over
    ``us`` as they are, ``padded=False``), and the output comes back at
    the grid's shape; only a one-shard column launch comes this way.  A
    chain launch runs on the
    padded buffers of :func:`_launch_inputs` and is trimmed back."""
    u0 = us[0]
    d = u0.ndim
    tile = tuple(int(t) for t in tile)
    if stages_w is None:
        return _direct(bind_apply(us, *_apply_geometry(tuple(offsets_w), tile),
                                  tile, sweep, pipelined, padded=False))(us)
    ins, offsets, weights, stages, lo_w, hi_w = _launch_inputs(
        us, offsets_w, tile, stages_w, bcs_w, dtypes_w, quants_w, in_quant
    )
    out = _padded_call(
        ins, (0,) * d, offsets, weights, stages, lo_w, hi_w, tile, sweep,
        pipelined, tuple(u0.shape), window_kind=window_kind,
        in_quant=in_quant,
    )
    with _TRIM:
        out = out[tuple(slice(0, n) for n in u0.shape)]
        if not out.is_contiguous():
            out = out.contiguous()
            obs.count(_TRIM_OP)
    return out


def _dtype_name(dt) -> str:
    """The canonical name of a dtype spelling — a torch dtype, a name, or
    a numpy/JAX dtype object — as ``jnp.dtype(dt).name`` gives it; an
    unknown name raises ``TypeError``."""
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    if isinstance(dt, str) and dt == "bfloat16":
        return "bfloat16"
    try:
        return np.dtype(dt).name
    except TypeError:
        raise TypeError(f"data type {dt!r} not understood") from None


def _as_tensors(us, device) -> tuple[torch.Tensor, ...]:
    dev = resolve_device(device)
    out = []
    for u in us:
        t = torch.as_tensor(u)
        out.append(t.to(dev).contiguous())
    return tuple(out)


def _planning_hardware(dev):
    """The card a plan for device ``dev`` is made for: the card's own
    description, or the published H100 figures for the CPU."""
    return hopper_device(dev) if dev.type == "cuda" else H100_SXM


def _auto_tile(shape, offsets_list, dtype_bytes, n_arrays, dev,
               vmem_budget=None, time_steps=1, stages=None, bcs=None,
               dtypes=None, window_kind="auto", tune=None, num_shards=1,
               mesh=None):
    """Plan for an un-tiled call — the reference's ``_auto_tile`` over the
    port's planner, for the card ``dev`` (the published H100 figures for a
    CPU tensor).  ``offsets_list`` and ``stages`` are per-RHS and per-stage
    offset tuples (weights stripped, so the plan is weight-independent);
    a repeated call is answered from the planner's memo of calls.

    ``tune`` (``True`` or an ``AutoTuner``) routes the decision through
    the measured tune loop instead: a warm TunedPlanDB hit serves the
    measured winner, a miss races the top-k candidates on ``dev`` first
    (``repro_torch.plan.tune``), a sharded request on the call's ``mesh``.
    ``num_shards > 1`` plans the worst shard's column slab."""
    from ..plan import resolve_tuner

    hardware = _planning_hardware(dev)
    signature = (shape, tuple(offsets_list), dtype_bytes, n_arrays,
                 hardware, vmem_budget, time_steps,
                 None if stages is None else tuple(stages), bcs, dtypes,
                 window_kind, num_shards)
    d = len(shape)
    kw = dict(
        shape=shape,
        dtype_bytes=dtype_bytes,
        vmem_budget=vmem_budget,
        n_operands=n_arrays + 1,
        window_kind=window_kind,
        hardware=hardware,
        num_shards=num_shards,
    )
    if mesh is not None:
        kw["mesh_axis"] = mesh.axis_names[0]
    if stages is not None:
        kw["stages"] = [np.asarray(o).reshape(-1, d) for o in stages]
        if bcs is not None and any(bc is not None for bc in bcs):
            kw["bcs"] = tuple(bcs)
        if dtypes is not None and any(dt is not None for dt in dtypes):
            kw["dtypes"] = tuple(dtypes)
    else:
        kw["offsets"] = [np.asarray(o).reshape(-1, d) for o in offsets_list]
        kw["time_steps"] = time_steps
    tuner = resolve_tuner(tune, dev)
    if tuner is not None:
        tuned_on = torch.device(tuner.device or "cuda")
        if tuned_on.type != dev.type:
            raise ValueError(
                f"tune= passes a tuner that measures on {tuner.device}, but "
                f"the call runs on {dev}"
            )
        return tuner.plan(mesh=mesh, **kw)
    return default_planner().plan_call(signature, **kw)


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

    ``time_steps=T > 1`` applies the stencil T times (one fused launch at
    an explicit ``tile``; as many as the plan says without one);
    ``dtypes=`` gives each application's storage dtype.  ``plan`` (a
    :class:`~repro_torch.plan.StencilPlan`) decides tile, sweep axis,
    window kind and fusion depth when given; otherwise ``tile=None`` asks
    the default planner, under ``vmem_budget`` bytes of shared memory per
    CTA.  ``device=None`` runs on the card."""
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
    chain is one fused launch; a plan may split it into several."""
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
    ``program.inputs()`` order.  A chain runs as one fused launch at an
    explicit ``tile``, or as ``ceil(T / plan.fused_depth)`` launches under
    a plan (``plan=``, or the default planner's for ``tile=None``);
    ``window_kind`` (``"ring"``, the default, or ``"trapezoid"``) picks
    the frontier layout and never changes the result.  ``dtypes=[dt_1,
    ..., dt_T]`` (single-RHS chains only) declares each stage's output
    dtype (``None`` = the input's); a program carries its boundaries,
    dtypes and quantizations on its ops.
    ``device=None`` runs on the card, ``device="cpu"`` runs the kernels'
    plain versions.

    ``tune=`` (``True`` or an ``AutoTuner``) swaps the planner for the
    measured tune loop; it excludes ``plan=`` and ``tile=``, which pin the
    decision already.  ``trace="path.json"`` records this call into a
    Chrome ``trace_event`` file (see :mod:`repro_torch.obs`).

    ``num_shards=S`` (or ``mesh=``, a one-axis mesh of
    :func:`~repro_torch.launch.mesh.make_column_mesh`, or a plan with
    ``num_shards > 1``) runs every launch column-sharded over S devices
    along ``shard_axis`` (the planner's or
    :func:`~repro_torch.parallel.shard_columns.pick_shard_axis`'s choice
    by default), bit-equal to the unsharded call.  Without a mesh the
    shards take the first S cards, or the CPU for a CPU call; shards share
    a card only through a mesh that names it for each."""
    if trace is not None:
        with obs.recording(trace):
            return multi_stencil_pallas(
                us, offsets_list, weights_list, tile=tile,
                vmem_budget=vmem_budget, sweep_axis=sweep_axis,
                pipelined=pipelined, plan=plan, time_steps=time_steps,
                stages=stages, num_shards=num_shards,
                shard_axis=shard_axis, mesh=mesh, tune=tune,
                program=program, dtypes=dtypes, window_kind=window_kind,
                device=device,
            )
    with obs.call():
        _FRONTEND.begin()
        args = (us, offsets_list, weights_list, tile, vmem_budget, sweep_axis,
                pipelined, plan, time_steps, stages, num_shards, shard_axis,
                mesh, tune, program, dtypes, window_kind, device)
        key = _memo_key(*args)
        entry = None if key is None else _CALL_MEMO.get(key)
        if (entry is not None and entry.planner is default_planner()
                and entry.binder is bind_apply):
            obs.count(_MEMO_HIT)
            _FRONTEND.then(_DECIDE)
            _DECIDE.end()
            return _run(entry, us)
        call, tensors = _resolve(*args)
        if key is not None:
            _CALL_MEMO.pop(key, None)
            if call.memo:
                obs.count(_MEMO_MISS)
                obs.mark_cold()
                if len(_CALL_MEMO) >= _CALL_MEMO_MAX:
                    _CALL_MEMO.pop(next(iter(_CALL_MEMO)))
                _CALL_MEMO[key] = call
        return _run(call, tensors)


# -- the call memo ------------------------------------------------------------

_CALL_MEMO: dict = {}
_CALL_MEMO_MAX = 256  # call signatures kept (oldest dropped first)


def _memo_key(us, offsets_list, weights_list, tile, vmem_budget, sweep_axis,
              pipelined, plan, time_steps, stages, num_shards, shard_axis,
              mesh, tune, program, dtypes, window_kind, device):
    """The call memo's key for :func:`multi_stencil_pallas`'s arguments:
    every value the call's launches consume, by content — each input's
    shape, dtype, device and strides, the offsets as int64 bytes with
    their shape, the weights as the caller's values in float64 bytes (so
    ``-0.0`` and ``0.0`` never share an entry), the options and
    ``device`` as passed.  ``None`` for every call the memo does not
    serve: an installed recorder, ``tune=``, ``plan=``, ``program=``,
    ``stages=``, sharding (``mesh=``, ``shard_axis=``, ``num_shards >
    1``), a default planner with a tuned DB, an input that is not a
    contiguous tensor on the call's device, offsets that are not
    integers, or an argument that cannot be part of a key (the call then
    raises as it always did)."""
    if (obs.enabled() or (tune is not None and tune is not False)
            or plan is not None or program is not None
            or stages is not None or mesh is not None
            or shard_axis is not None or (num_shards or 1) > 1
            or default_planner().tuned_db is not None):
        return None
    try:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        grids = []
        for u in us:
            if (type(u) is not torch.Tensor or u.device != dev
                    or not u.is_contiguous()):
                return None
            grids.append((u.shape, u.dtype, u.stride()))
        taps = []
        for o in offsets_list:
            o = np.asarray(o)
            if o.dtype.kind not in "iu":
                return None
            taps.append((o.shape, o.astype(np.int64, copy=False).tobytes()))
        for w in weights_list:
            w = np.asarray(w, dtype=np.float64)
            taps.append((w.shape, w.tobytes()))
        key = (tuple(grids), dev, tuple(taps), time_steps,
               None if dtypes is None else tuple(dtypes),
               None if tile is None else tuple(tile), vmem_budget,
               sweep_axis, pipelined, window_kind, device)
        hash(key)
    except (RuntimeError, TypeError, ValueError):
        return None
    return key


# -- the resolved call and its run loop ---------------------------------------


@dataclass(eq=False, slots=True)
class _Resolved:
    """A call resolved down to its launches, which :func:`_run` runs and
    the call memo stores: each ``launch(arrays) -> tensor``, the first
    over the inputs taken in ``order``.  ``memo``: every launch is a plain
    application bound for its buffers by ``binder`` (the module's
    :func:`~repro_torch.kernels.sweep.bind_apply` when the call was
    resolved), so the memo may serve the call while ``planner`` is the
    default planner and ``binder`` the module's binder.  The rest is what
    :func:`_launch_span` reports, ``runs`` each launch's ``(n_run, run,
    run_dts, run_qs)`` (``run`` ``None`` for a single application)."""

    planner: object
    binder: object
    order: tuple
    launches: tuple
    memo: bool
    program: object
    plan: object
    T: int
    tile: tuple
    sweep_axis: int
    depth: int
    num_shards: int
    device: str
    window_kind: str
    runs: tuple
    summary: dict | None = None


def _direct(bound):
    """A bound plain application as a launch that counts its direct read."""
    def launch(arrays):
        with _BUFFERS:
            obs.count(_DIRECT)
        return bound(arrays)

    return launch


def _resolve(us, offsets_list, weights_list, tile, vmem_budget, sweep_axis,
             pipelined, plan, time_steps, stages, num_shards, shard_axis,
             mesh, tune, program, dtypes, window_kind, device):
    """:func:`multi_stencil_pallas`'s call resolved, inside its root stage
    and its ``frontend`` stage: the rest of the ``frontend`` (inputs,
    program, lowering) and the ``decide`` stage (the launch decision and
    the launches, each built once).  Returns the :class:`_Resolved` call
    and the inputs as tensors, in the caller's order."""
    if tune and (plan is not None or tile is not None):
        raise ValueError(
            "tune= asks the measured tune loop for the launch decision, but "
            "plan=/tile= pin it already — pass one or the other"
        )
    if window_kind is not None and window_kind not in ("ring", "trapezoid"):
        raise ValueError(
            f"window_kind must be 'ring' or 'trapezoid', got {window_kind!r}"
        )
    if dtypes is not None:
        dtypes = tuple(
            _dtype_name(dt) if dt is not None else None for dt in dtypes
        )
    tensors = us = _as_tensors(us, device)
    if len({u.shape for u in us}) != 1:
        raise ValueError("RHS arrays must share a shape")
    d = us[0].ndim
    shape = tuple(int(n) for n in us[0].shape)
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
        prog = ir.chain_program(list(stages), d, dtypes=dtypes)
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
                dtypes=dtypes,
            )
        else:
            if dtypes is not None:
                raise ValueError(
                    "dtypes= requires a single-RHS stage chain"
                )
            prog = ir.rhs_program(offsets_list, weights_list, d=d)
    # -- verify + lower onto the engine's launch form ----------------------
    lowered = ir.lower(prog, shape)

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
        chain = tuple(static_spec(op) for op in lowered.stages)
        T = len(chain)
        bcs = tuple(lowered.bcs)
        # Per-stage output dtypes resolved against the chain input, as the
        # reference resolves ``eff``: a stage at the input dtype is the
        # same launch as one without a dtype; ``req_dtypes`` is the
        # None-normalized form the plan stack keys on.
        in_name = _dtype_name(us[0].dtype)
        eff = tuple(
            _dtype_name(dt) if dt is not None else in_name
            for dt in (lowered.dtypes or (None,) * T)
        )
        req_dtypes = tuple(dt if dt != in_name else None for dt in eff)
        if all(dt is None for dt in req_dtypes):
            eff = req_dtypes = None
        quants = tuple(lowered.quants or (None,) * T)
        offsets_list = [chain[0][0]]
        order = (0,)
    else:
        # multi-RHS single application: ``us`` arrives in load order;
        # stage p applies to lowered.inputs[p].
        if len(us) != len(lowered.inputs):
            raise ValueError(
                f"program loads {len(lowered.inputs)} inputs; got "
                f"{len(us)} arrays"
            )
        load_order = {name: i for i, name in enumerate(prog.inputs())}
        order = tuple(load_order[name] for name in lowered.inputs)
        us = tuple(us[i] for i in order)
        offsets_w = tuple(static_spec(op) for op in lowered.stages)
        chain = None
        bcs = ()
        T = 1
        req_dtypes = None
        offsets_list = [o for o, _ in offsets_w]
    # -- the launch decision: explicit tile, precompiled plan, or planner --
    _FRONTEND.then(_DECIDE)
    explicit_sweep = sweep_axis is not None
    explicit_shard = shard_axis is not None
    if mesh is not None and not (isinstance(mesh, ModelMesh)
                                 and len(mesh.axis_names) == 1):
        raise TypeError(
            "mesh= takes a one-axis mesh (repro_torch.launch.mesh."
            f"make_column_mesh), got {mesh!r}"
        )
    if num_shards is None:
        if mesh is not None:
            num_shards = mesh.size
        elif plan is not None:
            num_shards = plan.num_shards
    resolved_plan = plan
    if plan is not None:
        from ..plan import validate_plan_call

        validate_plan_call(
            plan, shape,
            [np.asarray(o, dtype=np.int64).reshape(-1, d)
             for o in offsets_list],
            us[0].element_size(), time_steps=T,
            stages=[o for o, _ in chain] if chain is not None else None,
            bcs=bcs if chain is not None else None,
            dtypes=req_dtypes if chain is not None else None,
        )
        pipelined = pipelined and plan.pipelined
    elif tile is None:
        resolved_plan = _auto_tile(
            shape, offsets_list, us[0].element_size(), len(us),
            us[0].device, vmem_budget=vmem_budget, time_steps=T,
            stages=[o for o, _ in chain] if chain is not None else None,
            bcs=bcs if chain is not None else None,
            dtypes=req_dtypes if chain is not None else None,
            window_kind=window_kind or "auto",
            tune=tune,
            num_shards=int(num_shards or 1),
            mesh=mesh,
        )
    depth = T  # explicit tile: the whole chain in one launch
    if resolved_plan is not None:
        if tile is None:
            tile = resolved_plan.tile
        if sweep_axis is None:
            sweep_axis = resolved_plan.sweep_axis
        if shard_axis is None:
            shard_axis = resolved_plan.shard_axis
        if window_kind is None:
            window_kind = resolved_plan.window_kind
        depth = int(resolved_plan.fused_depth)
    tile = tuple(int(t) for t in tile)
    sweep_axis = 0 if sweep_axis is None else int(sweep_axis)
    window_kind = window_kind or "ring"
    pipelined = bool(pipelined)
    num_shards = 1 if num_shards is None else int(num_shards)
    sharded = num_shards > 1 or (mesh is not None and mesh.size > 1)
    if (sharded and shard_axis is not None
            and int(shard_axis) == sweep_axis
            and explicit_shard != explicit_sweep):
        # Exactly one of the two axes was pinned by the caller and the
        # planner's choice of the other collided with it: the pin wins and
        # the free axis is derived again.
        from ..parallel.shard_columns import pick_shard_axis

        if explicit_shard:
            ncols = {i: -(-shape[i] // tile[i]) for i in range(d)
                     if i != int(shard_axis)}
            if ncols:  # a 1-d grid: the launcher raises its error
                sweep_axis = max(ncols, key=lambda i: (ncols[i], -i))
        else:
            shard_axis = pick_shard_axis(shape, tile, sweep_axis)
    if sharded:
        from ..parallel.shard_columns import column_launcher

        launcher = column_launcher(num_shards=num_shards,
                                   shard_axis=shard_axis, mesh=mesh)
    else:
        launcher = _stencil_call
    static = dict(tile=tile, sweep=sweep_axis, pipelined=pipelined)
    memo = not sharded  # every launch a bound plain application

    def plain(offsets_w):
        # A zero-fill application: sharded, or bound on the call's inputs,
        # the template of every later launch's (its last output has their
        # shape, dtype, device and strides).
        if sharded:
            return partial(launcher, offsets_w=offsets_w, **static)
        return _direct(bind_apply(us, *_apply_geometry(offsets_w, tile),
                                  tile, sweep_axis, pipelined, padded=False))

    # Launch i fuses stages [i·depth, (i+1)·depth); a launch with a
    # boundary, a stage dtype or a quantized stage takes the chain form
    # even for one stage, and a quantized hand-off reaches the next launch
    # as int8 codes with its quantization (``in_quant``).
    if chain is None:
        launches = [plain(offsets_w)]
        runs = [(1, None, None, None)]
    else:
        launches, runs = [], []
        in_q = None
        for pos in range(0, T, depth):
            run = chain[pos: pos + depth]
            run_bcs = bcs[pos: pos + len(run)]
            run_dts = eff[pos: pos + len(run)] if eff is not None else None
            run_qs = quants[pos: pos + len(run)]
            has_bc = any(bc is not None for bc in run_bcs)
            if has_bc or run_dts is not None:
                launch = partial(
                    launcher, offsets_w=(run[0],), **static, stages_w=run,
                    bcs_w=run_bcs if has_bc else None, dtypes_w=run_dts,
                    window_kind=window_kind,
                    quants_w=(run_qs if any(q is not None for q in run_qs)
                              else None),
                    in_quant=in_q,
                )
                memo = False
            elif len(run) == 1:
                launch = plain((run[0],))
            else:
                launch = partial(launcher, offsets_w=(run[0],), **static,
                                 stages_w=run, window_kind=window_kind)
                memo = False
            launches.append(launch)
            runs.append((len(run), run, run_dts, run_qs))
            in_q = run_qs[-1]
    call = _Resolved(
        planner=default_planner(), binder=bind_apply, order=order,
        launches=tuple(launches),
        memo=memo, program=prog, plan=resolved_plan, T=T, tile=tile,
        sweep_axis=sweep_axis, depth=depth, num_shards=num_shards,
        device=us[0].device.type, window_kind=window_kind, runs=tuple(runs),
    )
    _DECIDE.end()
    return call, tensors


def _launch_span(call, i):
    """Launch ``i`` of ``call``'s ``kernel_launch`` span, made with
    recording on only: prices the launch's slice of the plan's whole-chain
    model (n_run of T stages) and bumps the counters
    ``repro_torch.obs.report --check`` reconciles against the spans."""
    n_run, run, run_dts, run_qs = call.runs[i]
    if call.summary is None:
        call.summary = ir.summarize_program(call.program)
    p = call.plan
    if p is not None:
        share = n_run / max(call.T, 1)
        chain_bytes = (p.per_shard_traffic_bytes * p.num_shards
                       + p.halo_exchange_bytes)
        mb = round(chain_bytes * share)
        mf = round(p.modeled_flops * share)
        mms = p.modeled_ms * share
        plan_key = p.request.cache_key()
    else:
        mb = mf = 0  # explicit tile: the caller owns the model
        mms = 0.0
        plan_key = "<explicit-tile>"
    # The frontier part of this launch's shared memory under the resolved
    # window kind (core/tiling.py::sweep_smem_bytes).
    rsb = 0
    if run is not None and len(run) > 1:
        rsb = frontier_smem_bytes(
            call.tile, call.sweep_axis,
            [halo_from_offsets([o], len(call.tile)) for o, _ in run],
            call.window_kind,
        )
    quantized = run_qs is not None and any(q is not None for q in run_qs)
    obs.add("launches")
    obs.add("modeled_bytes", mb)
    obs.add("modeled_flops", mf)
    obs.add("ring_smem_bytes", rsb)
    if quantized:
        obs.add("quantized_launches")
    return obs.span(
        "kernel_launch",
        plan_key=plan_key, tile=list(call.tile), sweep_axis=call.sweep_axis,
        fused_depth=call.depth, steps=n_run, num_shards=call.num_shards,
        device=call.device, modeled_bytes=mb, modeled_flops=mf,
        modeled_ms=mms, program=call.summary, window_kind=call.window_kind,
        stage_dtypes=(list(run_dts) if run_dts is not None else None),
        ring_smem_bytes=rsb,
        stage_quants=(
            [list(q) if q is not None else None for q in run_qs]
            if quantized else None
        ),
    )


def _run(call, us):
    """The run loop: ``call``'s launches in turn, the first over ``us``
    taken in ``call.order``, each later one over the last one's output,
    each inside its ``kernel_launch`` span when a recorder is installed."""
    arrays = [us[i] for i in call.order]
    for i, launch in enumerate(call.launches):
        if obs.enabled():
            with _launch_span(call, i):
                arrays = [launch(arrays)]
        else:
            arrays = [launch(arrays)]
    return arrays[0]
