"""Wrappers of the two sweep kernels, each with its plain PyTorch version.

* :func:`sweep_apply` — ``csrc/sweep_apply.cu``: one application over p
  RHS arrays, ``q = Σ_p Σ_taps w·u_p[x+o]`` (parts B1 + B2 of the
  reference's ``_sweep_kernel``).
* :func:`sweep_chain` — ``csrc/sweep_chain.cu``: a fused T-stage chain
  with warm-up and streaming frontiers (parts B1 + B3 + B4).

Both take the *padded* launch buffers the host side builds
(``lo_w + k·tile + hi_w`` per dim) and return the padded result
(``k·tile`` per dim).  On a CPU tensor a wrapper runs its plain version;
on a CUDA tensor it launches its kernel or raises — there is no fallback.
Each wrapper carries an integer ``launches`` that counts kernel launches
and nothing else.
"""

from __future__ import annotations

import ctypes
from math import prod
from typing import Sequence

import numpy as np
import torch

from ..core.tiling import (
    chain_halo,
    frontier_depth,
    stage_suffix_halos,
    sweep_smem_bytes,
)
from . import _build

__all__ = [
    "THREADS",
    "chain_points",
    "chain_schedule",
    "sweep_apply",
    "sweep_apply_plain",
    "sweep_chain",
    "sweep_chain_plain",
]

THREADS = 256  # threads per CTA; the kernels declare __launch_bounds__(256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SCHED = 96  # kMaxSched of sweep_chain.cu


def _f32(w) -> float:
    """A weight rounded to f32, as a Python float (exact)."""
    return float(np.float32(w))


def _out_shape(x: torch.Tensor, lo_w, hi_w) -> tuple[int, ...]:
    return tuple(
        int(n) - int(l) - int(h) for n, l, h in zip(x.shape, lo_w, hi_w)
    )


def _effective_pipelined(pipelined, x, lo_w, hi_w, tile, sweep) -> bool:
    nswp = _out_shape(x, lo_w, hi_w)[sweep] // int(tile[sweep])
    return bool(pipelined) and nswp > 1 and (lo_w[sweep] + hi_w[sweep]) > 0


def _check(ins: Sequence[torch.Tensor], lo_w, hi_w, tile) -> None:
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
    if x0.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"sweep kernels take float32 or bfloat16, got {x0.dtype}"
        )
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


def _geom(x, out, lo_w, hi_w, tile, sweep, pipelined, n_in):
    """The int64 geometry head both C entry points read (23 entries)."""
    d = x.ndim
    tile3 = _lift(tile, d, 1)
    lo3 = _lift(lo_w, d, 0)
    win3 = tuple(
        t + l + h for t, l, h in zip(tile3, lo3, _lift(hi_w, d, 0))
    )
    s = int(sweep) + 3 - d
    ntiles = tuple(o // t for o, t in zip(_lift(out.shape, d, 1), tile3))
    cross = [i for i in range(3) if i != s]
    return [
        *_strides(x, d), *_strides(out, d), *tile3, *lo3, *win3,
        s, ntiles[s], ntiles[cross[0]], ntiles[cross[1]], int(pipelined),
        n_in, THREADS, _DTYPE_CODE[x.dtype],
    ]


def _raise_rc(name: str, rc: int) -> None:
    if rc == 0:
        return
    if rc == -1:
        raise RuntimeError(
            f"{name}: the kernel's shared-memory layout disagrees with "
            "sweep_smem_bytes, or exceeds 227 KB"
        )
    if rc == -2:
        raise RuntimeError(
            f"{name}: too many RHS, stages, taps or schedule entries for "
            "the kernel's fixed tables"
        )
    raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


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
        _P(ctypes.c_longlong), _P(ctypes.c_int), _P(ctypes.c_int),
        _P(ctypes.c_int), _P(ctypes.c_float), _P(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p,
    ],
}


def _entry(name: str):
    """The C entry point ``<name>_launch`` of kernel ``name``, typed."""
    fn = getattr(_build.load(name), f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES[f"{name}_launch"]
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
                      pipelined=True):
    """The tap loop over the zero-padded inputs: ``acc = acc + w·x[o]`` in
    f32, RHS by RHS in ``zip(offsets, weights)`` order, stored at the
    input dtype."""
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


def sweep_apply(ins, offsets, weights, lo_w, hi_w, tile, sweep,
                pipelined=True):
    """One stencil application over p padded RHS buffers (kernel 1).

    ``offsets[a]``/``weights[a]`` are RHS a's taps; ``lo_w``/``hi_w`` the
    window halo the buffers carry; the result is the padded output."""
    ins = list(ins)
    _check(ins, lo_w, hi_w, tile)
    d = ins[0].ndim
    pipe = _effective_pipelined(pipelined, ins[0], lo_w, hi_w, tile, sweep)
    smem = sweep_smem_bytes(
        tile, sweep, ins[0].element_size(), halo=list(zip(lo_w, hi_w)),
        n_inputs=len(ins), pipelined=pipe,
    )
    dev = ins[0].device
    if dev.type == "cpu":
        return sweep_apply_plain(ins, offsets, weights, lo_w, hi_w, tile,
                                 sweep, pipelined)
    if dev.type != "cuda":
        raise RuntimeError(f"sweep_apply: unsupported device {dev}")
    out = torch.empty(_out_shape(ins[0], lo_w, hi_w), dtype=ins[0].dtype,
                      device=dev)
    geom = _geom(ins[0], out, lo_w, hi_w, tile, sweep, pipe, len(ins))
    tap_begin = [0]
    tap_off: list[int] = []
    tap_w: list[float] = []
    for offs, wts in zip(offsets, weights):
        o, w = _taps(offs, wts, lo_w, hi_w, d)
        tap_off += o
        tap_w += w
        tap_begin.append(len(tap_w))
    fn = _entry("sweep_apply")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            _c(ctypes.c_longlong, geom),
            _c(ctypes.c_void_p, [x.data_ptr() for x in ins]),
            out.data_ptr(), _c(ctypes.c_int, tap_begin),
            _c(ctypes.c_int, tap_off), _c(ctypes.c_float, tap_w),
            smem, stream,
        )
    _raise_rc("sweep_apply", rc)
    sweep_apply.launches += 1
    return out


sweep_apply.launches = 0


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


def sweep_chain_plain(x, stages, lo_w, hi_w, tile, sweep, pipelined=True,
                      window_kind="ring", n_true=None, dom=None):
    """Stage by stage over the whole padded buffer: each stage's tap loop
    in f32 over its suffix-halo extent, every intermediate zeroed outside
    the true domain ``[0, n_true)`` (global coordinates, ``dom`` the
    origin's) and round-tripped through the stage dtype (the input's)."""
    d = x.ndim
    n_pad = _out_shape(x, lo_w, hi_w)
    n_true = tuple(int(n) for n in (n_true or n_pad))
    dom = tuple(int(v) for v in (dom or (0,) * d))
    cur = x.float()
    T = len(stages)
    for j, st in enumerate(stages):
        size = [
            n + int(sl) + int(sh)
            for n, sl, sh in zip(n_pad, st.suffix_lo, st.suffix_hi)
        ]
        acc = torch.zeros(size, dtype=torch.float32, device=x.device)
        for off, w in zip(np.asarray(st.offsets).tolist(), st.weights):
            sl = tuple(
                slice(l + o, l + o + n) for o, l, n in zip(off, st.lo, size)
            )
            acc = acc + _f32(w) * cur[sl]
        if j == T - 1:
            return acc.to(x.dtype)
        inside = torch.ones(size, dtype=torch.bool, device=x.device)
        for i in range(d):
            pos = torch.arange(size[i], device=x.device) + (
                dom[i] - int(st.suffix_lo[i])
            )
            ok = (pos >= 0) & (pos < n_true[i])
            shape = [1] * d
            shape[i] = size[i]
            inside = inside & ok.view(shape)
        acc = torch.where(inside, acc, torch.zeros((), device=x.device))
        cur = acc.to(x.dtype).float()
    raise ValueError("a chain needs at least one stage")


def sweep_chain(x, stages, lo_w, hi_w, tile, sweep, pipelined=True,
                window_kind="ring", n_true=None, dom=None):
    """A fused chain of T >= 2 stages over one padded buffer (kernel 2).

    ``stages`` carry ``offsets``, ``weights``, ``lo``/``hi`` and
    ``suffix_lo``/``suffix_hi`` per stage (the port's ``_Stage``);
    ``n_true`` is the unpadded grid and ``dom`` the global coordinate of
    its element 0 (zeros on one card)."""
    _check([x], lo_w, hi_w, tile)
    if len(stages) < 2:
        raise ValueError("sweep_chain fuses T >= 2 stages")
    if window_kind not in ("ring", "trapezoid"):
        raise ValueError(f"unknown window_kind {window_kind!r}")
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
    if x.device.type == "cpu":
        return sweep_chain_plain(x, stages, lo_w, hi_w, tile, sweep,
                                 pipelined, window_kind, n_true, dom)
    if x.device.type != "cuda":
        raise RuntimeError(f"sweep_chain: unsupported device {x.device}")
    n_pad = _out_shape(x, lo_w, hi_w)
    out = torch.empty(n_pad, dtype=x.dtype, device=x.device)
    geom = _geom(x, out, lo_w, hi_w, tile, sweep, pipe, len(stages))
    geom += list(_lift(n_true or n_pad, d, 1))
    geom += list(_lift(dom or (0,) * d, d, 0))
    stage_geom: list[int] = []
    tap_begin = [0]
    tap_off: list[int] = []
    tap_w: list[float] = []
    for j, st in enumerate(stages):
        stage_geom += [
            *_lift(st.lo, d, 0), *_lift(st.suffix_lo, d, 0),
            *_lift(
                [t + a + b for t, a, b in
                 zip(tile, st.suffix_lo, st.suffix_hi)], d, 1,
            ),
            depths[j] if j < len(depths) else 0,
        ]
        o, w = _taps(st.offsets, st.weights, st.lo, st.hi, d)
        tap_off += o
        tap_w += w
        tap_begin.append(len(tap_w))
    sched = [v for entry in warm + steady for v in entry]
    fn = _entry("sweep_chain")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(
            _c(ctypes.c_longlong, geom), _c(ctypes.c_int, stage_geom),
            _c(ctypes.c_int, tap_begin), _c(ctypes.c_int, tap_off),
            _c(ctypes.c_float, tap_w), _c(ctypes.c_int, sched),
            len(warm), len(steady), x.data_ptr(), out.data_ptr(), smem,
            stream,
        )
    _raise_rc("sweep_chain", rc)
    sweep_chain.launches += 1
    return out


sweep_chain.launches = 0


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
