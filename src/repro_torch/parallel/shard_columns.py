"""Column-sharded stencil launches: the port of the JAX package's
``parallel/shard_columns.py``.

Cross-axis tile columns of the sweep engine are independent (each CTA
owns a column and warms its own frontiers), so a launch parallelizes over
devices by *partitioning columns*: this module splits one cross axis of
the grid over a one-axis mesh
(:func:`~repro_torch.launch.mesh.make_column_mesh`), runs the
unmodified sweep kernel (``kernels.stencil._padded_call``) on each
shard's column slab, and exchanges only the halo rows at shard
boundaries.  The result is bit-equal to the single-device launch.

Per launch of a (possibly fused) stencil program:

* **Partition**: the shard axis ``a`` is a cross axis, never the sweep
  axis.  Every shard owns ``k`` whole tile columns (``C = k·tile_a``
  rows), with ``C ≥ max(lo_a, hi_a)`` so the chain's cone along ``a``
  reaches one neighbour only; round-up slack computes values that the
  gather drops, as the single-device pad does.
* **Scatter**: shard ``s`` gets rows ``[s·C, (s+1)·C)`` of each input on
  its device, padded on every other axis as the single-device launch
  pads (halo, round-up, periodic wrap) and with room for ``lo_a``/
  ``hi_a`` halo rows on the shard axis.
* **Halo exchange**: the trailing ``lo_a`` rows of each shard are copied
  into the next shard's low halo, the leading ``hi_a`` rows into the
  previous shard's high halo (``Tensor.copy_``, which PyTorch orders
  against the current streams of both cards).  Under a periodic boundary
  the ring closes over the shards that own true rows.
* **Global masks**: each shard passes its origin ``dom[a] = s·C`` to the
  kernel, which lifts a chain's masks and boundary classes into the true
  grid's coordinates.
* **Gather**: each shard's rows are copied back onto the input's device
  and trimmed to the grid.

Shards that share a card launch in order on its current stream.
"""

from __future__ import annotations

import functools
from math import prod
from typing import NamedTuple

import torch

from .. import obs
from ..kernels.stencil import (
    _launch_geometry,
    _padded_call,
    _round_up,
    _stencil_call,
    embed_inputs,
)
from ..launch.mesh import ModelMesh, make_column_mesh

__all__ = [
    "column_launcher",
    "exchange_halos",
    "pick_shard_axis",
    "sharded_stencil_call",
]


def pick_shard_axis(shape, tile, sweep_axis) -> int:
    """Default shard axis: the cross axis with the most tile columns
    (ties to the lowest index), never the sweep axis."""
    d = len(shape)
    cross = [i for i in range(d) if i != sweep_axis]
    if not cross:
        raise ValueError(
            f"column sharding needs a cross axis: grid {tuple(shape)} has "
            f"none besides sweep axis {sweep_axis}"
        )
    ncols = {i: -(-int(shape[i]) // int(tile[i])) for i in cross}
    return max(cross, key=lambda i: (ncols[i], -i))


def column_launcher(num_shards=None, shard_axis=None, mesh=None):
    """A drop-in for ``kernels.stencil._stencil_call`` that runs every
    launch column-sharded: what ``multi_stencil_pallas`` substitutes when
    the call (or its plan) asks for more than one shard."""

    def launch(us, offsets_w, tile, sweep, pipelined, stages_w=None,
               bcs_w=None, dtypes_w=None, window_kind="ring", quants_w=None,
               in_quant=None):
        return sharded_stencil_call(
            us, offsets_w, tile, sweep, pipelined, stages_w=stages_w,
            bcs_w=bcs_w, dtypes_w=dtypes_w, window_kind=window_kind,
            quants_w=quants_w, in_quant=in_quant, num_shards=num_shards,
            shard_axis=shard_axis, mesh=mesh,
        )

    return launch


class Slabs(NamedTuple):
    """Static geometry of one column-sharded launch (cached per launch
    signature by :func:`_slab_geometry`)."""

    offsets: list
    weights: list
    stages: tuple | None
    lo_w: tuple
    hi_w: tuple
    axis: int
    rows: int                  # C: rows of the shard axis a shard owns
    pads: tuple                # per-dim (lo, hi) of a slab before exchange
    wrap: tuple | None         # periodic ghost extents (none on the axis)
    last: int                  # the last shard that owns true rows
    n_last: int                # true rows shard ``last`` owns
    fwd: tuple                 # (src, dst) links of the lo_a trailing rows
    bwd: tuple                 # (src, dst) links of the hi_a leading rows
    exchange_rounds: int       # the reference's counters for this launch
    exchange_bytes: int


@functools.lru_cache(maxsize=128)
def _slab_geometry(num_shards, a, tile, offsets_w, stages_w, bcs_w, dtypes_w,
                  quants_w, shape, itemsize, p) -> Slabs:
    """The partition, pads and exchange links of one launch: ``shape`` is
    the grid, ``itemsize`` its element size, ``p`` the number of RHS."""
    d = len(shape)
    S = int(num_shards)
    offsets, weights, stages, lo_w, hi_w = _launch_geometry(
        offsets_w, stages_w, tile, bcs_w=bcs_w, dtypes_w=dtypes_w,
        quants_w=quants_w,
    )
    t_a = tile[a]
    lo_a, hi_a = lo_w[a], hi_w[a]
    n_a = shape[a]
    ncols = -(-n_a // t_a)
    k = max(-(-ncols // S), -(-lo_a // t_a), -(-hi_a // t_a), 1)
    C = k * t_a
    padded = [_round_up(n, t) for n, t in zip(shape, tile)]
    pads = tuple(
        (lo_a, hi_a) if i == a
        else (lo_w[i], hi_w[i] + padded[i] - shape[i])
        for i in range(d)
    )
    periodic = bcs_w is not None and any(
        bc is not None and bc[0] == "periodic" for bc in bcs_w
    )
    wrap = (
        tuple((0, 0) if i == a else (lo_w[i], hi_w[i]) for i in range(d))
        if periodic else None
    )
    # The ring closes over the shards that own true rows: shard ``last``
    # holds the grid's trailing rows (round-up slack may leave later
    # shards none), so the wrap links are last → 0 forward and 0 → last
    # backward, and shard last's forward send goes to shard 0 instead of
    # its slack neighbour.
    last = -(-n_a // C) - 1
    n_last = n_a - last * C
    if periodic and n_last < max(lo_a, hi_a, 1):
        raise ValueError(
            f"periodic shard axis {a}: the trailing shard owns {n_last} "
            f"true rows but the wrap bands need max(lo, hi) = "
            f"{max(lo_a, hi_a)} — the wrap would span more than one "
            "neighbor; use fewer shards or a smaller tile"
        )
    if periodic:
        fwd = [(s, s + 1) for s in range(S - 1) if s + 1 <= last]
        fwd.append((last, 0))
        bwd = [(s + 1, s) for s in range(S - 1) if s <= last - 1]
        bwd.append((0, last))
    else:
        fwd = [(s, s + 1) for s in range(S - 1)]
        bwd = [(s + 1, s) for s in range(S - 1)]
    # The JAX package's modelled figures, which its plan prices too: the
    # S − 1 interior boundaries each move lo_a + hi_a rows of the halo'd
    # cross extent, once per RHS.
    cross_ext = prod(
        padded[i] + lo_w[i] + hi_w[i] for i in range(d) if i != a
    )
    return Slabs(
        offsets=offsets, weights=weights, stages=stages, lo_w=lo_w,
        hi_w=hi_w, axis=a, rows=C, pads=pads, wrap=wrap,
        last=last, n_last=n_last,
        fwd=tuple(fwd) if lo_a else (), bwd=tuple(bwd) if hi_a else (),
        exchange_rounds=p * (int(lo_a > 0) + int(hi_a > 0)),
        exchange_bytes=p * (S - 1) * (lo_a + hi_a) * cross_ext * itemsize,
    )


def _scatter(us, g: Slabs, mesh: ModelMesh, fill=0) -> list[list]:
    """Each shard's launch buffers on its device, before the exchange:
    rows ``[s·C, (s+1)·C)`` of every input, padded as the single-device
    launch pads, with ``fill`` (the int8 zero point of a quantized input)
    in the shard axis's halo rows and slack."""
    a, C = g.axis, g.rows
    n_a = int(us[0].shape[a])
    out = []
    for s, dev in enumerate(mesh.devices):
        r0 = min(s * C, n_a)
        n = min(C, n_a - r0)
        pads = list(g.pads)
        pads[a] = (g.pads[a][0], g.pads[a][1] + C - n)
        slabs = [u.narrow(a, r0, n).to(dev) for u in us]
        out.append(embed_inputs(slabs, pads, wrap=g.wrap, fill=fill))
    return out


def exchange_halos(bufs, g: Slabs) -> None:
    """Copy the shard-boundary halo rows between the shards' buffers, in
    place: ``lo_a`` trailing rows forward, ``hi_a`` leading rows backward.

    Every halo row that no link fills keeps the launch's fill, as the
    single-device launch pads.  The JAX package's ``ppermute`` leaves 0
    there instead, which differs from the fill when the input is int8
    codes with a non-zero zero point (code 0 dequantizes to −zp·scale):
    its mesh-edge shards then disagree with its single-device launch."""
    a, C = g.axis, g.rows
    lo_a, hi_a = g.lo_w[a], g.hi_w[a]
    ragged = g.wrap is not None and g.n_last != C

    def end(s):  # one past the shard's last true row, under wrap
        return g.n_last if ragged and s == g.last else C

    for src, dst in g.fwd:
        for x_dst, x_src in zip(bufs[dst], bufs[src]):
            x_dst.narrow(a, 0, lo_a).copy_(
                x_src.narrow(a, end(src), lo_a))
    for src, dst in g.bwd:
        for x_dst, x_src in zip(bufs[dst], bufs[src]):
            x_dst.narrow(a, lo_a + end(dst), hi_a).copy_(
                x_src.narrow(a, lo_a, hi_a))


def _gather(outs, g: Slabs, shape, device) -> torch.Tensor:
    a, C = g.axis, g.rows
    out = torch.empty(shape, dtype=outs[0].dtype, device=device)
    for s, o in enumerate(outs):
        r0 = s * C
        n = min(C, shape[a] - r0)
        if n <= 0:
            break
        src = o[tuple(slice(0, n if i == a else shape[i])
                      for i in range(len(shape)))]
        out.narrow(a, r0, n).copy_(src)
    return out


def sharded_stencil_call(
    us, offsets_w, tile, sweep, pipelined, stages_w=None, bcs_w=None,
    dtypes_w=None, window_kind="ring", quants_w=None, in_quant=None,
    num_shards=None, shard_axis=None, mesh=None,
):
    """One column-sharded launch; arguments and result as
    ``kernels.stencil._stencil_call``'s, bit for bit.  ``mesh=None``
    builds one over ``num_shards`` devices of the input's kind
    (:func:`~repro_torch.launch.mesh.make_column_mesh`: the first cards,
    or the CPU); a 1-shard request is the single-device call."""
    us = tuple(us)
    u0 = us[0]
    d = u0.ndim
    tile = tuple(int(t) for t in tile)
    sweep = int(sweep)
    if mesh is None:
        num_shards = 1 if num_shards is None else int(num_shards)
        if num_shards > 1:
            mesh = make_column_mesh(num_shards, device=u0.device.type)
    elif num_shards is not None and int(num_shards) != mesh.size:
        raise ValueError(
            f"num_shards={num_shards} contradicts mesh of {mesh.size} devices"
        )
    if mesh is None or mesh.size == 1:
        return _stencil_call(
            us, offsets_w, tile, sweep, pipelined, stages_w=stages_w,
            bcs_w=bcs_w, dtypes_w=dtypes_w, window_kind=window_kind,
            quants_w=quants_w, in_quant=in_quant,
        )
    if shard_axis is None:
        shard_axis = pick_shard_axis(u0.shape, tile, sweep)
    a = int(shard_axis)
    if not 0 <= a < d:
        raise ValueError(f"shard_axis {a} out of range for {d}-d grid")
    if a == sweep:
        raise ValueError(
            f"shard_axis {a} is the sweep axis: columns are partitioned "
            "across the sweep, not along it"
        )
    shape = tuple(int(n) for n in u0.shape)
    g = _slab_geometry(
        mesh.size, a, tile, offsets_w, stages_w, bcs_w, dtypes_w, quants_w,
        shape, u0.element_size(), len(us),
    )

    def run():
        fill = int(in_quant[1]) if in_quant is not None else 0
        bufs = _scatter(us, g, mesh, fill)
        exchange_halos(bufs, g)
        outs = []
        for s, ins in enumerate(bufs):
            dom = [0] * d
            dom[a] = s * g.rows
            outs.append(_padded_call(
                ins, dom, g.offsets, g.weights, g.stages, g.lo_w, g.hi_w,
                tile, sweep, pipelined, shape, window_kind=window_kind,
                in_quant=in_quant,
            ))
        return _gather(outs, g, shape, u0.device)

    if not obs.enabled():
        return run()
    obs.add("halo_exchange_rounds", g.exchange_rounds)
    obs.add("halo_exchange_bytes", g.exchange_bytes)
    with obs.span(
        "halo_exchange", shard_axis=a, num_shards=mesh.size,
        rows_lo=g.lo_w[a], rows_hi=g.hi_w[a],
        exchange_rounds=g.exchange_rounds, exchange_bytes=g.exchange_bytes,
    ):
        return run()
