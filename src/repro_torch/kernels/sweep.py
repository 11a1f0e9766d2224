"""Wrappers of the two sweep kernels, each with its plain PyTorch version.

* :func:`sweep_apply` — ``csrc/sweep_apply.cu``: one application over p
  RHS arrays, ``q = Σ_p Σ_taps w·u_p[x+o]`` (parts B1 + B2 of the
  reference's ``_sweep_kernel``).
* :func:`sweep_chain` — ``csrc/sweep_chain.cu``: a chain of T >= 1
  stages with warm-up and streaming frontiers, boundary correction taps,
  per-stage storage dtypes and int8-quantized frontiers (parts B1 + B3 +
  B4 + B5 + B6).

The chain takes the *padded* launch buffer the host side builds
(``lo_w + k·tile + hi_w`` per dim) and returns the padded result
(``k·tile`` per dim).  The apply takes such buffers too, or, with
``padded=False``, the caller's grid as it is: its kernel zero-fills the
window where it leaves the grid and returns the grid's shape.  On a CPU
tensor a wrapper runs its plain version; on a CUDA tensor it launches its
kernel or raises — there is no fallback.
Each wrapper is the call's ``sweep_launch`` stage and counts its kernel
in ``repro_torch.obs.totals()``: ``device_ops.kernel`` for either
version (and, for the plain apply on a caller's grid, the fill and the
copy-in of the padded copy it makes, which the kernel does not),
``launches.sweep_apply`` / ``launches.sweep_chain`` for a launch on the
card alone, ``apply_rows.copy16`` / ``apply_rows.span`` for an apply
launch whose window rows took the flat copy / also its widened rows, and
``apply_rows.pair`` for one whose bf16 kernel computed two neighbouring
outputs a thread (each as the launcher reports it set them up), and
``launch_table_hit`` / ``launch_table_miss`` for the card's launch tables
(a miss, or a kernel library's load, makes the call cold).
:func:`bind_apply` binds one apply launch for buffers of one shape, dtype
and device, so that the call memo of :mod:`repro_torch.kernels.stencil`
repeats it with no checks, key or table lookup.
"""

from __future__ import annotations

import ctypes
import itertools
from math import prod
from typing import Sequence

import numpy as np
import torch

from .. import obs
from ..core.tiling import (
    H100_SXM,
    SMEM_BLOCK_LIMIT,
    HopperDevice,
    apply_smem_bytes,
    chain_halo,
    frontier_depth,
    stage_suffix_halos,
    sweep_smem_bytes,
)
from . import _build

__all__ = [
    "APPLY_THREADS",
    "apply_copy16",
    "apply_occupancy",
    "bind_apply",
    "CHAIN_THREADS",
    "chain_occupancy",
    "chain_points",
    "chain_schedule",
    "hopper_device",
    "sweep_apply",
    "sweep_apply_plain",
    "sweep_chain",
    "sweep_chain_plain",
]

# Threads per CTA, each equal to its kernel's __launch_bounds__:
APPLY_THREADS = 512  # csrc/sweep_apply.cu (kThreads)
CHAIN_THREADS = 512  # csrc/sweep_chain.cu (kThreads)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_APPLY_DTYPES = (torch.float32, torch.bfloat16)
# The fixed tables of sweep_chain.cu: kMaxStages, kMaxTaps, kMaxSched,
# kMaxBc (rows of the correction-term table) and the class lists' rows.
_MAX_STAGES = 8
_MAX_TAPS = 160
_MAX_SCHED = 96
_MAX_BC = 4096
_MAX_LISTED = 65535  # rows of the class lists (unsigned short bounds)
_BC_ROW = 8  # int32 per correction term; see _bc_table
# sweep_apply_launch's return: on success the bits of the row path it set
# up (kRowsCopy16, kRowsSpan, kRowsPair), on a failed launch -16 less the
# CUDA error (kCudaErrorBase).
_ROWS_COPY16 = 1
_ROWS_SPAN = 2
_ROWS_PAIR = 4
_CUDA_ERROR_BASE = 16

_SWEEP_LAUNCH = obs.stage("sweep_launch")
_KERNEL = obs.counter("device_ops.kernel")
_FILL = obs.counter("device_ops.fill")
_COPY_IN = obs.counter("device_ops.copy_in")
_APPLY_LAUNCHES = obs.counter("launches.sweep_apply")
_ROWS_COPY16_N = obs.counter("apply_rows.copy16")
_ROWS_SPAN_N = obs.counter("apply_rows.span")
_ROWS_PAIR_N = obs.counter("apply_rows.pair")
_CHAIN_LAUNCHES = obs.counter("launches.sweep_chain")
_TABLE_HIT = obs.counter("launch_table_hit")
_TABLE_MISS = obs.counter("launch_table_miss")


def _f32(w) -> float:
    """A weight rounded to f32, as a Python float (exact)."""
    return float(np.float32(w))


def _out_shape(x: torch.Tensor, lo_w, hi_w) -> tuple[int, ...]:
    return tuple(
        int(n) - int(l) - int(h) for n, l, h in zip(x.shape, lo_w, hi_w)
    )


def _apply_out_shape(x: torch.Tensor, lo_w, hi_w, padded) -> tuple:
    """An apply's output shape: the padded buffer's less its halo, or the
    caller's grid's own."""
    return _out_shape(x, lo_w, hi_w) if padded else tuple(x.shape)


def _effective_pipelined(pipelined, x, lo_w, hi_w, tile, sweep,
                         padded=True) -> bool:
    n = _apply_out_shape(x, lo_w, hi_w, padded)[sweep]
    nswp = -(-n // int(tile[sweep]))
    return bool(pipelined) and nswp > 1 and (lo_w[sweep] + hi_w[sweep]) > 0


def _check(ins: Sequence[torch.Tensor], lo_w, hi_w, tile,
           dtypes=_APPLY_DTYPES, padded=True) -> None:
    x0 = ins[0]
    if not 1 <= x0.ndim <= 3 or len(tile) != x0.ndim:
        raise ValueError(
            f"sweep kernels take 1-3 dim grids with a tile per axis, got "
            f"{x0.ndim} dims and tile {tuple(tile)}"
        )
    for x in ins:
        if x.shape != x0.shape or x.dtype != x0.dtype or x.device != x0.device:
            raise ValueError("RHS buffers must share shape, dtype and device")
        if not x.is_contiguous():
            raise ValueError("sweep kernels take contiguous buffers")
    if x0.dtype not in dtypes:
        names = " or ".join(str(t).removeprefix("torch.") for t in dtypes)
        raise TypeError(f"this sweep kernel takes {names}, got {x0.dtype}")
    if not padded:
        if x0.numel() == 0 or min(int(t) for t in tile) < 1:
            raise ValueError(
                f"an empty grid {tuple(x0.shape)} or tile {tuple(tile)}")
        return
    for n, t in zip(_out_shape(x0, lo_w, hi_w), tile):
        if n <= 0 or n % int(t):
            raise ValueError(
                f"padded buffer {tuple(x0.shape)} is not lo_w + k*tile + "
                f"hi_w for tile {tuple(tile)}"
            )


def _lift(vals, d, fill):
    """A per-axis tuple lifted to 3-D by leading axes of value ``fill``."""
    return (fill,) * (3 - d) + tuple(int(v) for v in vals)


def _lift_offsets(offs, d) -> np.ndarray:
    offs = np.asarray(offs, dtype=np.int64).reshape(-1, d)
    return np.concatenate(
        [np.zeros((len(offs), 3 - d), np.int64), offs], axis=1
    )


def _strides(x: torch.Tensor, d: int):
    return _lift(x.stride(), d, 0)


def _geom(x, out, lo_w, hi_w, tile, sweep, pipelined, n_in, threads):
    """The int64 geometry head both C entry points read (23 entries); a
    last tile may stop short of the tile (the apply on the caller's
    grid)."""
    d = x.ndim
    tile3 = _lift(tile, d, 1)
    lo3 = _lift(lo_w, d, 0)
    win3 = tuple(
        t + l + h for t, l, h in zip(tile3, lo3, _lift(hi_w, d, 0))
    )
    s = int(sweep) + 3 - d
    ntiles = tuple(-(-o // t) for o, t in zip(_lift(out.shape, d, 1), tile3))
    cross = [i for i in range(3) if i != s]
    return [
        *_strides(x, d), *_strides(out, d), *tile3, *lo3, *win3,
        s, ntiles[s], ntiles[cross[0]], ntiles[cross[1]], int(pipelined),
        n_in, threads, _DTYPE_CODE[x.dtype],
    ]


def _raise_rc(name: str, rc: int) -> None:
    """Raise on a launcher's error code: the chain's positive CUDA errors,
    the apply's ``-_CUDA_ERROR_BASE - e``, and the shared -1 to -3."""
    if rc == 0:
        return
    if rc == -1:
        raise RuntimeError(
            f"{name}: the kernel's shared-memory layout disagrees with "
            "sweep_smem_bytes, or exceeds 227 KB"
        )
    if rc == -2:
        raise RuntimeError(
            f"{name}: too many RHS, stages, taps, schedule entries or "
            "correction terms for the kernel's fixed tables (or, for the "
            "chain, 2^22 or more sweep rows)"
        )
    if rc == -3:
        raise RuntimeError(
            f"{name}: the threads per CTA differ from the kernel's "
            "__launch_bounds__"
        )
    err = rc if rc > 0 else -_CUDA_ERROR_BASE - rc
    raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _c(ctype, vals):
    return (ctype * max(len(vals), 1))(*vals)


_P = ctypes.POINTER
_ARGTYPES = {
    "sweep_apply_launch": [
        _P(ctypes.c_longlong), _P(ctypes.c_void_p), ctypes.c_void_p,
        _P(ctypes.c_int), _P(ctypes.c_int), _P(ctypes.c_float),
        ctypes.c_int, ctypes.c_void_p,
    ],
    "sweep_chain_launch": [
        _P(ctypes.c_longlong), _P(ctypes.c_int), _P(ctypes.c_float),
        _P(ctypes.c_int), _P(ctypes.c_int), _P(ctypes.c_float),
        _P(ctypes.c_int), ctypes.c_int, ctypes.c_int, _P(ctypes.c_int),
        ctypes.c_void_p, _P(ctypes.c_int), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p,
    ],
    "sweep_chain_occupancy": [ctypes.c_int, ctypes.c_int],
    "sweep_apply_occupancy": [ctypes.c_int] * 3,
    "sweep_apply_copy16": [_P(ctypes.c_longlong), _P(ctypes.c_void_p)],
}


_ENTRIES: dict = {}


def _entry(name: str, what: str = "launch"):
    """The C entry point ``<name>_<what>`` of kernel ``name``, typed."""
    fn = _ENTRIES.get((name, what))
    if fn is None:
        obs.mark_cold()
        fn = getattr(_build.load(name), f"{name}_{what}")
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[f"{name}_{what}"]
        _ENTRIES[name, what] = fn
    return fn


def _taps(offsets, weights, lo, hi, d):
    """Taps lifted to 3-D offsets and f32 weights, after checking that
    every offset stays inside the halo the buffers carry (the kernels
    index shared memory with them unchecked)."""
    offs = np.asarray(offsets, dtype=np.int64).reshape(-1, d)
    if len(offs) != len(weights):
        raise ValueError(f"{len(offs)} offsets but {len(weights)} weights")
    if (offs < -np.asarray(lo)).any() or (offs > np.asarray(hi)).any():
        raise ValueError(
            f"stencil offsets reach past the halo lo={tuple(lo)} "
            f"hi={tuple(hi)}"
        )
    return _lift_offsets(offs, d).reshape(-1).tolist(), [
        _f32(w) for w in weights
    ]


# -- kernel 1: one application over p RHS ------------------------------------


def sweep_apply_plain(ins, offsets, weights, lo_w, hi_w, tile, sweep,
                      pipelined=True, *, padded=True):
    """The tap loop over the zero-padded inputs: ``acc = acc + w·x[o]`` in
    f32, RHS by RHS in ``zip(offsets, weights)`` order, stored at the
    input dtype.  ``padded=False``: the inputs are the caller's grids,
    padded here with the halo's zeros (the result has their shape)."""
    if not padded:
        pad = [v for lo, hi in zip(lo_w[::-1], hi_w[::-1])
               for v in (int(lo), int(hi))]
        ins = [torch.nn.functional.pad(x, pad) for x in ins]
    out_shape = _out_shape(ins[0], lo_w, hi_w)
    acc = torch.zeros(out_shape, dtype=torch.float32, device=ins[0].device)
    for x, offs, wts in zip(ins, offsets, weights):
        xf = x.float()
        for off, w in zip(np.asarray(offs).tolist(), wts):
            sl = tuple(
                slice(l + o, l + o + n)
                for o, l, n in zip(off, lo_w, out_shape)
            )
            acc = acc + _f32(w) * xf[sl]
    return acc.to(ins[0].dtype)


def _row_pad(x, lo_w, hi_w, tile, sweep) -> int:
    """Elements a direct read's shared window row needs beyond the window
    for the flat copy to take every 16-byte block the row touches: where
    the rows take the flat copy (c1 the minor axis; the sweep and c0
    strides and the tile's c1 extent 16-byte multiples; each row a piece
    of 0, 4 or 8 bytes up to its first 16-byte boundary and after its
    last) and have an end piece, the bytes from each piece out to its
    block's edge; else 0.  (The base address is the launcher's to check:
    off a 16-byte boundary, no row takes the flat copy.)"""
    d = x.ndim
    es = x.element_size()
    s = int(sweep) + 3 - d
    c0, c1 = [i for i in range(3) if i != s]
    st3 = _strides(x, d)
    if st3[c1] != 1 or any(v * es % 16 for v in (
            st3[s], st3[c0], _lift(tile, d, 1)[c1])):
        return 0
    a1 = c1 - 3 + d  # c1's axis of the grid
    w1 = int(tile[a1]) + int(lo_w[a1]) + int(hi_w[a1])
    head = int(lo_w[a1]) * es % 16
    tail = (w1 * es - head) % 16
    if head not in (0, 4, 8) or tail not in (0, 4, 8) or w1 * es < head + tail:
        return 0
    return ((16 - head) % 16 + (16 - tail) % 16) // es


def _apply_ctas(x, sweep, smem) -> int:
    """CTAs of the apply kernel an SM at ``smem`` bytes: the card's own
    occupancy query, or the published H100's for a CPU tensor."""
    if x.device.type == "cuda":
        return apply_occupancy(x.dtype, int(sweep) + 3 - x.ndim, smem)
    return H100_SXM.ctas_per_sm("apply", smem)


def _apply_key(ins, offsets, weights, lo_w, hi_w, tile, sweep,
               pipelined, padded=True) -> tuple:
    """Everything an apply launch's arrays depend on — the buffers' shape,
    strides, dtype, device and count, whether they are padded, the taps
    (each RHS's offsets as int64 and weights rounded to f32, as bytes) and
    the options — as one hashable tuple."""
    x = ins[0]
    return (
        "apply", tuple(x.shape), tuple(x.stride()), str(x.dtype),
        str(x.device), len(ins), bool(padded),
        tuple(np.asarray(o, dtype=np.int64).tobytes() for o in offsets),
        tuple(np.asarray(w, dtype=np.float32).tobytes() for w in weights),
        tuple(int(v) for v in lo_w), tuple(int(v) for v in hi_w),
        tuple(int(t) for t in tile), int(sweep), bool(pipelined),
    )


def _apply_plan(ins, offsets, weights, lo_w, hi_w, tile, sweep,
                pipelined, padded=True) -> dict:
    """Check an apply launch and build what the kernel is handed but the
    buffers: the output's shape, the shared bytes and the C arrays.
    Raises on what the kernel does not take."""
    x = ins[0]
    d = x.ndim
    pipe = _effective_pipelined(pipelined, x, lo_w, hi_w, tile, sweep,
                                padded)
    layout = (tile, sweep, x.element_size(), list(zip(lo_w, hi_w)),
              x.stride())
    smem = apply_smem_bytes(*layout, n_inputs=len(ins), pipelined=pipe)
    # A direct read's rows copy their end pieces with the 16-byte blocks
    # around them where the wider shared rows leave the CTAs an SM as
    # they are (the pieces, each its own line, cost more apart).
    row_pad = 0 if padded else _row_pad(x, lo_w, hi_w, tile, sweep)
    if row_pad:
        try:
            wide = apply_smem_bytes(*layout, n_inputs=len(ins),
                                    pipelined=pipe, row_pad=row_pad)
        except ValueError:
            wide = None
        if wide is not None and (_apply_ctas(x, sweep, wide)
                                 >= _apply_ctas(x, sweep, smem)):
            smem = wide
        else:
            row_pad = 0
    out = torch.empty(_apply_out_shape(x, lo_w, hi_w, padded),
                      dtype=x.dtype, device="meta")
    geom = _geom(x, out, lo_w, hi_w, tile, sweep, pipe, len(ins),
                 APPLY_THREADS)
    # The inputs' extents, the window coordinate of their element 0 and
    # the output's extents.
    geom += [*_lift(x.shape, d, 1),
             *(_lift((0,) * d if padded else lo_w, d, 0)),
             *_lift(out.shape, d, 1), row_pad]
    tap_begin = [0]
    tap_off: list[int] = []
    tap_w: list[float] = []
    for offs, wts in zip(offsets, weights):
        o, w = _taps(offs, wts, lo_w, hi_w, d)
        tap_off += o
        tap_w += w
        tap_begin.append(len(tap_w))
    return dict(
        out_shape=tuple(out.shape), smem=smem,
        geom=_c(ctypes.c_longlong, geom),
        taps=(_c(ctypes.c_int, tap_begin), _c(ctypes.c_int, tap_off),
              _c(ctypes.c_float, tap_w)),
    )


_PLANS: dict = {}
_PLANS_MAX = 64  # launch plans kept, apply and chain (oldest dropped first)


def _cached_plan(key, build) -> dict:
    """The launch plan kept under ``key``, built by ``build()`` at its first
    use; the oldest of :data:`_PLANS_MAX` plans is dropped first."""
    plan = _PLANS.get(key)
    if plan is None:
        obs.count(_TABLE_MISS)
        obs.mark_cold()
        plan = build()
        if len(_PLANS) >= _PLANS_MAX:
            _PLANS.pop(next(iter(_PLANS)))
        _PLANS[key] = plan
    else:
        obs.count(_TABLE_HIT)
    return plan


def _apply_table(ins, offsets, weights, lo_w, hi_w, tile, sweep, pipelined,
                 padded) -> dict:
    """A card apply launch, checked, and its kept plan (a counted
    launch-table lookup)."""
    _check(ins, lo_w, hi_w, tile, padded=padded)
    args = (ins, offsets, weights, lo_w, hi_w, tile, sweep, pipelined)
    return _cached_plan(_apply_key(*args, padded),
                        lambda: _apply_plan(*args, padded))


def sweep_apply(ins, offsets, weights, lo_w, hi_w, tile, sweep,
                pipelined=True, *, padded=True):
    """One stencil application over p RHS arrays (kernel 1).

    ``offsets[a]``/``weights[a]`` are RHS a's taps and ``lo_w``/``hi_w``
    the window halo they reach.  ``padded`` says what the inputs are, as
    the caller knows it (a shape cannot tell): launch buffers that carry
    the halo and the round-up to the tile, whose result is the padded
    output; or, ``False``, the caller's grids as they are, read with
    zeros outside them, whose result has their shape.  On the card a
    launch's arrays are built once per geometry and kept
    (:func:`_apply_plan`), and the launcher's return, the row path it set
    up, is counted (``apply_rows.copy16``, ``apply_rows.span``,
    ``apply_rows.pair``)."""
    with _SWEEP_LAUNCH:
        ins = list(ins)
        args = (ins, offsets, weights, lo_w, hi_w, tile, sweep, pipelined)
        dev = ins[0].device
        if dev.type == "cuda":
            return _launch_apply(_entry("sweep_apply"),
                                 _apply_table(*args, padded), ins)
        _check(ins, lo_w, hi_w, tile, padded=padded)
        if dev.type == "cpu":
            _apply_plan(*args, padded)
            if not padded:
                # The plain version pads each grid: a fill and a copy-in.
                obs.count(_FILL, len(ins))
                obs.count(_COPY_IN, len(ins))
            obs.count(_KERNEL)
            return sweep_apply_plain(*args, padded=padded)
        raise RuntimeError(f"sweep_apply: unsupported device {dev}")


def _raw_stream(idx: int) -> int:
    """The current CUDA stream of card ``idx``, as its ``cudaStream_t``."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(idx)
    return torch.cuda.current_stream(idx).cuda_stream


def _launch_apply(fn, plan, ins) -> torch.Tensor:
    """One apply launch of ``plan`` over the CUDA buffers ``ins`` on the
    current stream of their card: the output's allocation, the launch, and
    its counts (the kernel, the launch and the row path its launcher
    returned)."""
    dev = ins[0].device
    out = torch.empty(plan["out_shape"], dtype=ins[0].dtype, device=dev)
    args = (plan["geom"], _c(ctypes.c_void_p, [x.data_ptr() for x in ins]),
            out.data_ptr(), *plan["taps"], plan["smem"])
    if torch.cuda.current_device() == dev.index:
        rc = fn(*args, _raw_stream(dev.index))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, _raw_stream(dev.index))
    if rc < 0:
        _raise_rc("sweep_apply", rc)
    obs.count(_KERNEL)
    obs.count(_APPLY_LAUNCHES)
    if rc & _ROWS_COPY16:
        obs.count(_ROWS_COPY16_N)
    if rc & _ROWS_SPAN:
        obs.count(_ROWS_SPAN_N)
    if rc & _ROWS_PAIR:
        obs.count(_ROWS_PAIR_N)
    return out


def bind_apply(ins, offsets, weights, lo_w, hi_w, tile, sweep,
               pipelined=True, *, padded=True):
    """:func:`sweep_apply` with these arguments, bound for buffers of
    ``ins``' shape, strides, dtype, device and count: ``launch(bufs)``
    runs it over ``bufs``, which the caller vouches are such buffers.

    On the card the launch plan is bound (:func:`_apply_table`) and kept
    here, whatever ``_PLANS`` drops: it holds no device memory.  So a
    launch only allocates its output and launches on the current stream,
    within the ``sweep_launch`` stage and with :func:`sweep_apply`'s
    counts; on the CPU ``launch`` is :func:`sweep_apply` itself."""
    args = (offsets, weights, lo_w, hi_w, tile, sweep, pipelined)
    ins = list(ins)
    if ins[0].device.type != "cuda":
        return lambda bufs: sweep_apply(bufs, *args, padded=padded)
    plan = _apply_table(ins, *args, padded)
    fn = _entry("sweep_apply")

    def launch(bufs):
        with _SWEEP_LAUNCH:
            return _launch_apply(fn, plan, bufs)

    return launch


def apply_copy16(ins, offsets, weights, lo_w, hi_w, tile, sweep,
                 pipelined=True, *, padded=True) -> bool:
    """Whether :func:`sweep_apply` with these arguments copies every window
    row by one flat index of 16-byte blocks, with at most a 4- or 8-byte
    piece at each end of a row (the kernel's ``copy16`` path), as the
    launcher decides it for these buffers.  Needs the card; launches
    nothing."""
    ins = list(ins)
    if ins[0].device.type != "cuda":
        raise RuntimeError("apply_copy16: the launcher runs on the card only")
    plan = _apply_table(ins, offsets, weights, lo_w, hi_w, tile, sweep,
                        pipelined, padded)
    return bool(_entry("sweep_apply", "copy16")(
        plan["geom"], _c(ctypes.c_void_p, [x.data_ptr() for x in ins])))


def apply_occupancy(dtype, sweep_axis, smem_bytes) -> int:
    """CTAs of the apply kernel built for this dtype and sweep axis (of
    the grid lifted to 3-D) resident on one SM of the current card at this much dynamic shared
    memory and :data:`APPLY_THREADS` threads (CUDA's occupancy query).
    Needs the card; launches nothing."""
    n = _entry("sweep_apply", "occupancy")(_DTYPE_CODE[dtype],
                                           int(sweep_axis), int(smem_bytes))
    if n < 0:
        raise RuntimeError(f"sweep_apply_occupancy: cudaError {-n}")
    return n


# -- kernel 2: fused stage chain ----------------------------------------------


def _stage_halos(stages):
    return [list(zip(st.lo, st.hi)) for st in stages]


def chain_schedule(stages, tile, sweep, window_kind):
    """The kernel's work list for one sweep column.

    Returns ``(warm, steady, depths)``: ``warm`` the ``(stage, r0, r1)``
    entries run at sweep step 0, ``steady`` those run at every later step
    (rows relative to the step's first output row ``k·t_s``), ``depths``
    each frontier's ring depth.  Under ``"trapezoid"`` the warm-up is the
    reference's ``full_compute`` (each stage over its whole extent);
    under ``"ring"`` the frontiers are too shallow for that, so the
    warm-up advances each stage in chunks, as far as its source has rows
    and its own ring has room.  Every later step computes the ``t_s``
    newly uncovered rows of each stage (``streaming_step``)."""
    T = len(stages)
    s = int(sweep)
    t_s = int(tile[s])
    halos = _stage_halos(stages)
    depths = [
        frontier_depth(tile, halos, j, s, window_kind) for j in range(T - 1)
    ]
    steady = [
        (j, int(st.suffix_hi[s]), t_s + int(st.suffix_hi[s]))
        for j, st in enumerate(stages)
    ]
    a = [-int(st.suffix_lo[s]) for st in stages]
    end = [t_s + int(st.suffix_hi[s]) for st in stages]
    if window_kind == "trapezoid":
        warm = [(j, a[j], end[j]) for j in range(T)]
    else:
        warm = []
        while a[T - 1] < end[T - 1]:
            progressed = False
            for j in range(T):
                lim = end[j]
                if j > 0:  # stage j-1 has rows < a[j-1]
                    lim = min(lim, a[j - 1] - int(stages[j].hi[s]))
                if j < T - 1:  # keep the rows stage j+1 still reads
                    lim = min(
                        lim, a[j + 1] - int(stages[j + 1].lo[s]) + depths[j]
                    )
                if lim > a[j]:
                    warm.append((j, a[j], lim))
                    a[j] = lim
                    progressed = True
            assert progressed, (a, end)
    return warm, steady, depths


_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}
_ROUND_F32, _ROUND_BF16, _ROUND_QUANT = 0, 1, 2


def _dtype_of(name, x_dtype) -> torch.dtype:
    """A stage dtype name (``None`` = the launch input's) as a torch dtype
    the chain kernel stores."""
    if name is None:
        return x_dtype
    if name not in _NAMES:
        raise TypeError(
            f"sweep_chain stores float32, bfloat16 or int8 stages, got "
            f"{name!r}"
        )
    return _NAMES[name]


def _stage_rounding(stages, x_dtype) -> list[int]:
    """Per stage, how its stored value is rounded: 0 none (f32), 1 through
    bf16, 2 onto its affine int8 grid (quantize, then dequantize for the
    next stage's reads)."""
    codes = []
    for j, st in enumerate(stages):
        dt = _dtype_of(st.dtype, x_dtype)
        if st.quant is not None:
            codes.append(_ROUND_QUANT)
        elif dt == torch.int8:
            raise ValueError(
                f"stage {j} stores int8 without a (scale, zero_point): an "
                "int8 stage is a quantized one"
            )
        else:
            codes.append(_ROUND_BF16 if dt == torch.bfloat16 else _ROUND_F32)
    return codes


def _quant_pair(q):
    """``(scale, zero_point)`` as the f32 values the arithmetic uses."""
    return np.float32(q[0]).item(), float(int(q[1]))


def _quantize(acc, q):
    """``clip(round_half_even(acc / s) + zp, -128, 127)`` in f32 — the
    reference's ``quantize_store`` before its int8 cast.  The divisor is a
    tensor: PyTorch divides a CUDA tensor by a Python scalar as a multiply
    by its reciprocal, which is not the IEEE quotient."""
    s, zp = _quant_pair(q)
    s = torch.tensor(s, dtype=torch.float32, device=acc.device)
    return torch.clamp(torch.round(acc / s) + zp, -128.0, 127.0)


def _dequantize(x, q):
    """``(x - zp) · s`` in f32 — the reference's read of an int8 source."""
    s, zp = _quant_pair(q)
    return (x - zp) * s


def bc_menu(st, n_true):
    """The correction terms of stage ``st``'s boundary condition, in the
    reference's order (``bc_terms`` of ``repro/kernels/stencil.py``).

    Yields ``(kind, tests, offset, coef)``: ``kind`` ``"const"`` adds
    ``coef`` where the tap's read leaves the domain along any axis of
    ``tests`` (``(axis, tap offset)`` pairs); ``"read"`` adds ``coef ·
    src[x + offset]`` where every ``(axis, plane)`` test of ``tests``
    holds (the output cell lies on that global plane).  ``coef`` is the
    f32 product the reference forms on the host: ``w·c`` for the
    dirichlet/robin constant, ``gain·w`` for a clamped (neumann, robin's
    α-scaled part) or mirrored (reflect) read.  Periodic and zero fill
    yield nothing."""
    if st.bc is None or st.bc[0] == "periodic":
        return
    kind, cval = st.bc
    d = len(st.lo)
    mode = "neumann" if kind == "robin" else kind
    gain = np.float32(cval[0]) if kind == "robin" else np.float32(1)
    for off, w in zip(np.asarray(st.offsets).tolist(), st.weights):
        off = tuple(int(o) for o in off)
        mix = [i for i in range(d) if off[i] != 0]
        if not mix:
            continue
        if kind in ("dirichlet", "robin"):
            c = cval if kind == "dirichlet" else cval[1]
            yield ("const", tuple((i, off[i]) for i in mix), off,
                   np.float32(w) * np.float32(c))
            if kind == "dirichlet":
                continue
        menus = []
        for i in mix:
            opts: list = [None]
            o = off[i]
            if o < 0:
                for e in range(1, -o + 1):
                    oc = o + e if mode == "neumann" else o + 2 * e
                    opts.append((-o - e, oc))
            else:
                for e in range(1, o + 1):
                    oc = o - e if mode == "neumann" else o - 2 * e
                    opts.append((int(n_true[i]) - 1 + e - o, oc))
            menus.append(opts)
        for combo in itertools.product(*menus):
            if all(c is None for c in combo):
                continue
            oc = list(off)
            tests = []
            for i, c in zip(mix, combo):
                if c is None:
                    continue
                tests.append((i, c[0]))
                oc[i] = c[1]
            yield ("read", tuple(tests), tuple(oc), gain * np.float32(w))


def _bc_terms(st, src, size, pos, n_true):
    """The plain correction sum of one stage over its whole extent
    ``size``: a separate f32 sum from zero, term by term in
    :func:`bc_menu` order (``pos[i]`` the global coordinate of each
    output index along axis i)."""
    d = len(size)
    add = torch.zeros(size, dtype=torch.float32, device=src.device)

    def along(i, v):
        shape = [1] * d
        shape[i] = size[i]
        return v.view(shape)

    for kind, tests, oc, coef in bc_menu(st, n_true):
        if kind == "const":
            inside = torch.ones(size, dtype=torch.bool, device=src.device)
            for i, o in tests:
                q = pos[i] + o
                inside = inside & along(i, (q >= 0) & (q < int(n_true[i])))
            add = add + torch.where(
                inside, torch.zeros((), device=src.device),
                torch.tensor(coef, device=src.device),
            )
            continue
        mask = torch.ones(size, dtype=torch.bool, device=src.device)
        for i, plane in tests:
            mask = mask & along(i, pos[i] == plane)
        sl = tuple(
            slice(l + o, l + o + n) for o, l, n in zip(oc, st.lo, size)
        )
        add = add + torch.where(
            mask, torch.tensor(coef, device=src.device) * src[sl],
            torch.zeros((), device=src.device),
        )
    return add


def sweep_chain_plain(x, stages, lo_w, hi_w, tile, sweep, pipelined=True,
                      window_kind="ring", n_true=None, dom=None,
                      in_quant=None):
    """Stage by stage over the whole padded buffer, as the reference's
    ``stage_apply`` computes each element: the source dequantized when it
    holds int8 codes (``in_quant`` for the launch input), the tap loop in
    f32 over the stage's suffix-halo extent, plus the boundary correction
    sum; every intermediate zeroed outside the true domain ``[0, n_true)``
    (global coordinates, ``dom`` the origin's; widened by the suffix halo
    under periodic wrap) and rounded through its stage dtype.  The result
    is the last stage's, at its dtype (int8 codes if it is quantized)."""
    d = x.ndim
    n_pad = _out_shape(x, lo_w, hi_w)
    n_true = tuple(int(n) for n in (n_true or n_pad))
    dom = tuple(int(v) for v in (dom or (0,) * d))
    rounding = _stage_rounding(stages, x.dtype)
    out_dtype = _dtype_of(stages[-1].dtype, x.dtype)
    periodic = any(st.bc is not None and st.bc[0] == "periodic"
                   for st in stages)
    cur = x.float()
    if in_quant is not None:
        cur = _dequantize(cur, in_quant)
    T = len(stages)
    zero = torch.zeros((), device=x.device)
    for j, st in enumerate(stages):
        size = [
            n + int(sl) + int(sh)
            for n, sl, sh in zip(n_pad, st.suffix_lo, st.suffix_hi)
        ]
        pos = [
            torch.arange(size[i], device=x.device)
            + (dom[i] - int(st.suffix_lo[i]))
            for i in range(d)
        ]
        acc = torch.zeros(size, dtype=torch.float32, device=x.device)
        for off, w in zip(np.asarray(st.offsets).tolist(), st.weights):
            sl = tuple(
                slice(l + o, l + o + n) for o, l, n in zip(off, st.lo, size)
            )
            acc = acc + _f32(w) * cur[sl]
        if st.bc is not None and st.bc[0] != "periodic":
            acc = acc + _bc_terms(st, cur, size, pos, n_true)
        if j == T - 1:
            if st.quant is not None:
                acc = _quantize(acc, st.quant)
            return acc.to(out_dtype)
        inside = torch.ones(size, dtype=torch.bool, device=x.device)
        for i in range(d):
            lob, hib = 0, n_true[i]
            if periodic:
                lob = -int(st.suffix_lo[i])
                hib = n_true[i] + int(st.suffix_hi[i])
            ok = (pos[i] >= lob) & (pos[i] < hib)
            shape = [1] * d
            shape[i] = size[i]
            inside = inside & ok.view(shape)
        acc = torch.where(inside, acc, zero)
        if rounding[j] == _ROUND_QUANT:
            cur = _dequantize(_quantize(acc, st.quant), st.quant)
        elif rounding[j] == _ROUND_BF16:
            cur = acc.to(torch.bfloat16).float()
        else:
            cur = acc
    raise ValueError("a chain needs at least one stage")


_NONE = -(2 ** 31)  # a table row's untested role


def _bc_table(stages, tile, lo_w, hi_w, sweep, n_true):
    """The correction-term table (``csrc/sweep_chain.cu`` reads its rows
    class by class, in the order of the :func:`_bc_classes` lists):
    per-stage row ranges ``begin`` (T + 1 prefix counts) and the rows, 8
    int32 each, in :func:`bc_menu` order:

    ``[kind, v_s, v_c0, v_c1, o_s, o_c, coef_bits, stage]`` — ``kind`` 0
    for a constant (it fires where ``pos + v`` leaves ``[0, n_true)``
    along any tested role), 1 for a read (it fires where ``pos == v`` on
    every tested role); ``v_s``, ``v_c0``, ``v_c1`` the tested value per
    role (the sweep axis and the two cross axes of the lifted 3-D grid),
    :data:`_NONE` where the term tests nothing; ``o_s`` the corrected
    offset along the sweep axis and ``o_c`` within the source plane
    (``o[c0] · src_w1 + o[c1]``, as the taps'); ``coef`` the f32
    coefficient's bits.  Raises when a corrected offset leaves the stage's
    halo (the kernel indexes shared memory with it unchecked)."""
    d = len(tile)
    s = int(sweep) + 3 - d
    c0, c1 = [i for i in range(3) if i != s]
    role = {s: 0, c0: 1, c1: 2}
    win = _lift([t + l + h for t, l, h in zip(tile, lo_w, hi_w)], d, 1)
    begin = [0]
    rows: list[list[int]] = []
    for j, st in enumerate(stages):
        src_w1 = win[c1] if j == 0 else _lift(stages[j - 1].ext, d, 1)[c1]
        for kind, tests, off, coef in bc_menu(st, n_true):
            off3 = _lift(off, d, 0)
            if kind == "read" and any(
                not -lo <= o <= hi for o, lo, hi in zip(off, st.lo, st.hi)
            ):
                raise ValueError(
                    f"stage {j}: a {st.bc[0]} correction reads offset "
                    f"{off}, outside the stage halo lo={tuple(st.lo)} "
                    f"hi={tuple(st.hi)}"
                )
            row = [0 if kind == "const" else 1, _NONE, _NONE, _NONE]
            for i, v in tests:
                row[1 + role[i + 3 - d]] = int(v)
            if kind == "read":
                row += [off3[s], off3[c0] * src_w1 + off3[c1]]
            else:
                row += [0, 0]
            row += [int(np.float32(coef).view(np.int32)), j]
            rows.append(row)
        begin.append(len(rows))
    return begin, rows


N_CLASSES = 27  # position classes of an element: 3 per axis


def position_class(p, lo, hi, n) -> int:
    """A coordinate's class along one axis for a stage of halo ``(lo,
    hi)`` on ``[0, n)``: 0 below ``lo``, 2 at or above ``n - hi``, else 1
    (``pos_class`` in ``csrc/sweep_chain.cu``)."""
    if p < lo:
        return 0
    return 2 if p >= n - hi else 1


def _bc_classes(stages, begin, rows, sweep, n_true) -> list[int]:
    """Per stage and position class, the rows of the correction-term table
    (:func:`_bc_table`) that can fire there, in table order: ``T·27 + 1``
    list bounds (stage-major, class ``9·c_s + 3·c_0 + c_1`` over the
    roles sweep, c0, c1 of the lifted grid, :func:`position_class`
    each), then the row indices.  A read fires only on its planes, so it
    is listed where each plane's class is the element's; a constant fires
    only where its tap leaves the domain, which needs a class other than 1
    along one of its axes.  Class (1, 1, 1) lists nothing."""
    d = len(n_true)
    s = int(sweep) + 3 - d
    c0, c1 = [i for i in range(3) if i != s]
    axes = (s, c0, c1)
    n3 = _lift(n_true, d, 1)
    bounds: list[int] = []
    index: list[int] = []
    for j, st in enumerate(stages):
        lo3, hi3 = _lift(st.lo, d, 0), _lift(st.hi, d, 0)

        def cls(role, v):
            a = axes[role]
            return position_class(v, lo3[a], hi3[a], n3[a])

        for k in range(N_CLASSES):
            want = (k // 9, k // 3 % 3, k % 3)
            bounds.append(len(index))
            for q in range(begin[j], begin[j + 1]):
                row = rows[q]
                tests = [(r, v) for r, v in enumerate(row[1:4])
                         if v != _NONE]
                if row[0] == 0:
                    fires = any(want[r] != 1 for r, _ in tests)
                else:
                    fires = all(cls(r, v) == want[r] for r, v in tests)
                if fires:
                    index.append(q)
    bounds.append(len(index))
    return bounds + index


def _bc_key(bc):
    """A boundary condition as the launch consumes it: its kind and its
    values rounded to f32 (a robin pair stays a pair)."""
    if bc is None:
        return None
    kind, val = bc
    vals = np.atleast_1d(np.asarray(val, dtype=np.float64)).ravel()
    return (str(kind), tuple(_f32(v) for v in vals.tolist()))


def _plan_key(x, stages, lo_w, hi_w, tile, sweep, pipelined, window_kind,
              n_true, dom, in_quant) -> tuple:
    """Everything a chain launch's tables depend on — the buffer's shape,
    strides, dtype and device (not its data or address), the stages and
    the options — as one hashable tuple of plain ints, floats and strings,
    each value normalized as the launch consumes it (weights, boundary
    values and quantization pairs as f32), so that two launches share a
    key only if they build the same tables."""
    def ints(v):
        return None if v is None else tuple(int(a) for a in v)

    return (
        tuple(x.shape), tuple(x.stride()), str(x.dtype), str(x.device),
        tuple((
            tuple(np.asarray(st.offsets, dtype=np.int64).ravel().tolist()),
            tuple(_f32(w) for w in st.weights), ints(st.lo), ints(st.hi),
            ints(st.suffix_lo), ints(st.suffix_hi), ints(st.ext),
            _bc_key(st.bc), None if st.dtype is None else str(st.dtype),
            None if st.quant is None else _quant_pair(st.quant),
        ) for st in stages),
        ints(lo_w), ints(hi_w), ints(tile), int(sweep), bool(pipelined),
        str(window_kind), ints(n_true), ints(dom),
        None if in_quant is None else _quant_pair(in_quant),
    )


def _chain_plan(x, stages, lo_w, hi_w, tile, sweep, pipelined, window_kind,
                n_true, dom, in_quant) -> dict:
    """Check a chain launch and, for a CUDA buffer, build everything the
    kernel is handed but the buffers: the C arrays and the correction-term
    tables on the device.  Raises on what the kernel does not take."""
    _check([x], lo_w, hi_w, tile, dtypes=tuple(_NAMES.values()))
    T = len(stages)
    if not 1 <= T <= _MAX_STAGES:
        raise ValueError(
            f"sweep_chain fuses T >= 1 stages, at most {_MAX_STAGES}; got {T}"
        )
    if window_kind not in ("ring", "trapezoid"):
        raise ValueError(f"unknown window_kind {window_kind!r}")
    if in_quant is not None and x.dtype != torch.int8:
        raise TypeError(
            f"in_quant dequantizes int8 codes; the input is {x.dtype}"
        )
    d = x.ndim
    pipe = _effective_pipelined(pipelined, x, lo_w, hi_w, tile, sweep)
    halos = _stage_halos(stages)
    suffix = stage_suffix_halos(halos)
    if [tuple(h) for h in chain_halo(halos)] != list(zip(lo_w, hi_w)) or any(
        list(zip(st.suffix_lo, st.suffix_hi)) != [tuple(h) for h in sfx]
        for st, sfx in zip(stages, suffix)
    ):
        raise ValueError(
            "stage halos do not add up to the buffer's window halo"
        )
    rounding = _stage_rounding(stages, x.dtype)
    out_dtype = _dtype_of(stages[-1].dtype, x.dtype)
    n_pad = _out_shape(x, lo_w, hi_w)
    n_true = tuple(int(n) for n in (n_true or n_pad))
    smem = sweep_smem_bytes(
        tile, sweep, x.element_size(), n_inputs=1, pipelined=pipe,
        stage_halos=halos, window_kind=window_kind,
    )
    warm, steady, depths = chain_schedule(stages, tile, sweep, window_kind)
    if len(warm) + len(steady) > _MAX_SCHED:
        raise ValueError(
            f"chain warm-up needs {len(warm)} schedule entries; the kernel "
            f"holds {_MAX_SCHED - len(steady)} — use a deeper sweep tile"
        )
    n_taps = sum(len(st.weights) for st in stages)
    if n_taps > _MAX_TAPS:
        raise ValueError(
            f"the chain has {n_taps} taps; the kernel holds {_MAX_TAPS}"
        )
    bc_begin, bc_rows = _bc_table(stages, tile, lo_w, hi_w, sweep, n_true)
    if len(bc_rows) > _MAX_BC:
        raise ValueError(
            f"the chain's boundary conditions need {len(bc_rows)} "
            f"correction terms; the kernel holds {_MAX_BC}"
        )
    bc_cls = _bc_classes(stages, bc_begin, bc_rows, sweep, n_true)
    if bc_cls[T * N_CLASSES] > _MAX_LISTED:
        raise ValueError(
            f"the chain's class lists hold {bc_cls[T * N_CLASSES]} "
            f"correction-term rows; the kernel holds {_MAX_LISTED}"
        )
    plan = {"n_true": n_true}
    if x.device.type != "cuda":
        return plan
    out = torch.empty(n_pad, dtype=out_dtype, device="meta")
    geom = _geom(x, out, lo_w, hi_w, tile, sweep, pipe, T, CHAIN_THREADS)
    geom += list(_lift(n_true, d, 1))
    geom += list(_lift(dom or (0,) * d, d, 0))
    geom += [
        _DTYPE_CODE[out_dtype], int(in_quant is not None),
        int(any(st.bc is not None and st.bc[0] == "periodic"
                for st in stages)),
    ]
    stage_geom: list[int] = []
    stage_q: list[float] = []
    tap_begin = [0]
    tap_off: list[int] = []
    tap_w: list[float] = []
    for j, st in enumerate(stages):
        stage_geom += [
            *_lift(st.lo, d, 0), *_lift(st.hi, d, 0),
            *_lift(st.suffix_lo, d, 0), *_lift(st.ext, d, 1),
            depths[j] if j < len(depths) else 0, rounding[j],
            int(st.bc is not None and st.bc[0] != "periodic"),
        ]
        stage_q += list(_quant_pair(st.quant or (1.0, 0)))
        o, w = _taps(st.offsets, st.weights, st.lo, st.hi, d)
        tap_off += o
        tap_w += w
        tap_begin.append(len(tap_w))
    stage_q += list(_quant_pair(in_quant or (1.0, 0)))
    sched = [v for entry in warm + steady for v in entry]
    # The kernel reads each class's rows contiguously, in its list's order,
    # and takes the classes' bounds as parameters.
    nb = T * N_CLASSES + 1
    by_class = [bc_rows[q] for q in bc_cls[nb:]] or [[0] * _BC_ROW]
    plan.update(
        out_shape=n_pad, out_dtype=out_dtype, smem=smem,
        arrays=(
            _c(ctypes.c_longlong, geom), _c(ctypes.c_int, stage_geom),
            _c(ctypes.c_float, stage_q), _c(ctypes.c_int, tap_begin),
            _c(ctypes.c_int, tap_off), _c(ctypes.c_float, tap_w),
            _c(ctypes.c_int, sched), len(warm), len(steady),
            _c(ctypes.c_int, bc_begin),
        ),
        bc=torch.tensor(by_class, dtype=torch.int32, device=x.device),
        bounds=_c(ctypes.c_int, bc_cls[:nb]),
    )
    return plan


def sweep_chain(x, stages, lo_w, hi_w, tile, sweep, pipelined=True,
                window_kind="ring", n_true=None, dom=None, in_quant=None):
    """A fused chain of T >= 1 stages over one padded buffer (kernel 2).

    ``stages`` carry ``offsets``, ``weights``, ``lo``/``hi``,
    ``suffix_lo``/``suffix_hi``, ``bc``, ``dtype`` and ``quant`` per stage
    (the port's ``_Stage``); ``n_true`` is the unpadded grid and ``dom``
    the global coordinate of its element 0 (zeros on one card);
    ``in_quant`` the ``(scale, zero_point)`` of an int8 input.  The
    result is the padded output at the last stage's dtype.

    On the card a launch's tables are built once per geometry and kept
    (:func:`_chain_plan`): a repeated launch allocates its output and
    launches."""
    with _SWEEP_LAUNCH:
        args = (x, stages, lo_w, hi_w, tile, sweep, pipelined, window_kind,
                n_true, dom, in_quant)
        if x.device.type == "cuda":
            plan = _cached_plan(_plan_key(*args), lambda: _chain_plan(*args))
        else:
            plan = _chain_plan(*args)
            if x.device.type != "cpu":
                raise RuntimeError(
                    f"sweep_chain: unsupported device {x.device}")
            obs.count(_KERNEL)
            return sweep_chain_plain(x, stages, lo_w, hi_w, tile, sweep,
                                     pipelined, window_kind, plan["n_true"],
                                     dom, in_quant)
        out = torch.empty(plan["out_shape"], dtype=plan["out_dtype"],
                          device=x.device)
        fn = _entry("sweep_chain")
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device)
            rc = fn(*plan["arrays"], plan["bc"].data_ptr(), plan["bounds"],
                    x.data_ptr(), out.data_ptr(), plan["smem"],
                    stream.cuda_stream)
        _raise_rc("sweep_chain", rc)
        # The kept rows may be dropped from the cache, and their memory
        # reused on the stream that allocated them, while this launch still
        # reads them on another: the allocator holds them until it is done.
        plan["bc"].record_stream(stream)
        obs.count(_KERNEL)
        obs.count(_CHAIN_LAUNCHES)
        return out


def chain_occupancy(in_dtype, smem_bytes) -> int:
    """CTAs of the chain kernel resident on one SM of the current card for
    this input dtype and this much dynamic shared memory, at
    :data:`CHAIN_THREADS` threads (CUDA's occupancy query,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).
    Needs the card; launches nothing."""
    n = _entry("sweep_chain", "occupancy")(
        _DTYPE_CODE[in_dtype], int(smem_bytes))
    if n < 0:
        raise RuntimeError(f"sweep_chain_occupancy: cudaError {-n}")
    return n


def chain_points(stages, tile, sweep, window_kind, out_shape) -> list[int]:
    """Per stage, the outputs the fused kernel computes over the whole
    padded grid ``out_shape`` (warm-up and streaming, halo overlap of
    neighbouring columns included): the operations bound's count."""
    warm, steady, _ = chain_schedule(stages, tile, sweep, window_kind)
    s = int(sweep)
    d = len(tile)
    ntiles = [int(n) // int(t) for n, t in zip(out_shape, tile)]
    cols = prod(ntiles[i] for i in range(d) if i != s)
    pts = [0] * len(stages)
    for steps, entries in ((1, warm), (ntiles[s] - 1, steady)):
        for j, r0, r1 in entries:
            st = stages[j]
            plane = prod(
                int(tile[i]) + int(st.suffix_lo[i]) + int(st.suffix_hi[i])
                for i in range(d) if i != s
            )
            pts[j] += steps * cols * (r1 - r0) * plane
    return pts


_DEVICES: dict = {}


def hopper_device(dev) -> HopperDevice:
    """The cost model's description of CUDA device ``dev``, read once per
    device: SMs, shared memory per SM and L2 from
    ``torch.cuda.get_device_properties``, the HBM rate from its memory
    clock and bus width (the published H100 figure where this PyTorch does
    not report them), and each sweep kernel's most resident CTAs from its
    occupancy query at no dynamic shared memory (which builds the kernels
    on first use)."""
    dev = torch.device(dev)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    desc = _DEVICES.get(idx)
    if desc is None:
        p = torch.cuda.get_device_properties(idx)
        clock_khz = getattr(p, "memory_clock_rate", 0)
        bus_bits = getattr(p, "memory_bus_width", 0)
        rate = (2 * clock_khz * 1e3 * bus_bits / 8 if clock_khz and bus_bits
                else H100_SXM.hbm_bytes_per_s)
        with torch.cuda.device(idx):
            apply_ctas = apply_occupancy(torch.float32, 2, 0)
            chain_ctas = chain_occupancy(torch.float32, 0)
        desc = HopperDevice(
            name=p.name,
            sm_count=p.multi_processor_count,
            smem_per_block=SMEM_BLOCK_LIMIT,
            smem_per_sm=getattr(p, "shared_memory_per_multiprocessor",
                                H100_SXM.smem_per_sm),
            l2_bytes=p.L2_cache_size,
            hbm_bytes_per_s=float(rate),
            apply_threads=APPLY_THREADS,
            apply_ctas_per_sm=apply_ctas,
            chain_threads=CHAIN_THREADS,
            chain_ctas_per_sm=chain_ctas,
        )
        _DEVICES[idx] = desc
    return desc
