"""Launch geometry and the Hopper cost model of the sweep kernels.

``dtype_itemsize``, ``halo_from_offsets``, ``chain_halo``,
``stage_suffix_halos``, ``surface_to_volume``, ``fused_halo``,
``tile_traffic_bytes`` (the DRAM bytes model), ``chain_flops`` and
``_traffic_lower_bound`` are copies of the JAX package's ``core/tiling``,
so that the port's launch geometry and traffic figures equal the
reference's on the same inputs.

``sweep_smem_bytes`` and ``apply_smem_bytes`` reckon one CTA's dynamic
shared memory from the same geometry, laid out exactly as
``csrc/sweep_chain.cu`` and ``csrc/sweep_apply.cu`` carve it.

The tile search is rebuilt for an H100 (the reference's scores HBM bytes
under a TPU VMEM budget split per operand, on TPU lane/sublane grains):

* candidates take a 128-byte coalescing grain on the minor axis
  (:func:`candidate_tiles`);
* a tile is feasible when its kernel's own shared-memory layout fits the
  budget (at most :data:`SMEM_BLOCK_LIMIT`); outputs leave from registers,
  so no output tile is staged;
* the score is modelled time (:func:`launch_model`): the larger of the
  DRAM bytes over the card's bandwidth and the kernel's issue time (its
  4-row thread items, in whole rounds of the CTA's threads, times taps,
  at a per-kernel cost per round and tap, over the CTAs resident on the
  card), times the wave quantisation of the columns over SMs × CTAs per
  SM.  :class:`HopperDevice` describes the card.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass
from math import prod
from typing import Sequence

import numpy as np

from .isoperimetric import lower_bound_loads

__all__ = [
    "APPLY_ROUND_TAP_S",
    "CHAIN_ROUND_TAP_S",
    "H100_SXM",
    "HopperDevice",
    "LINE_BYTES",
    "SMEM_BLOCK_LIMIT",
    "TileChoice",
    "apply_smem_bytes",
    "candidate_tiles",
    "chain_flops",
    "chain_halo",
    "dtype_itemsize",
    "frontier_depth",
    "frontier_smem_bytes",
    "fused_halo",
    "halo_from_offsets",
    "launch_model",
    "minor_unit",
    "select_tile",
    "stage_suffix_halos",
    "surface_to_volume",
    "sweep_smem_bytes",
    "tile_traffic_bytes",
]

# Dynamic shared memory one block may use on an H100 (227 KB of the SM's
# 256 KB), above 48 KB only after cudaFuncAttributeMaxDynamicSharedMemorySize.
SMEM_BLOCK_LIMIT = 232448

# Element sizes of the dtypes the engine accepts, keyed by canonical name.
_DTYPE_BYTES = {
    "float64": 8, "int64": 8,
    "float32": 4, "int32": 4, "uint32": 4,
    "bfloat16": 2, "float16": 2, "int16": 2, "uint16": 2,
    "int8": 1, "uint8": 1,
}


def dtype_itemsize(name: str) -> int:
    """Bytes per element of a canonical dtype name (bfloat16-aware)."""
    try:
        return _DTYPE_BYTES[str(name)]
    except KeyError:
        raise ValueError(
            f"unsupported dtype {name!r}; expected one of "
            f"{sorted(_DTYPE_BYTES)}"
        ) from None


def halo_from_offsets(
    offsets_list: Sequence, d: int
) -> list[tuple[int, int]]:
    """Per-dim asymmetric halo (lo, hi) covering every offset of every RHS:
    lo_i = max(0, -min o_i), hi_i = max(0, max o_i)."""
    lo = [0] * d
    hi = [0] * d
    for offs in offsets_list:
        offs = np.asarray(offs, dtype=np.int64).reshape(-1, d)
        for i in range(d):
            lo[i] = max(lo[i], int(max(0, -offs[:, i].min(initial=0))))
            hi[i] = max(hi[i], int(max(0, offs[:, i].max(initial=0))))
    return list(zip(lo, hi))


def chain_halo(
    stage_halos: Sequence[Sequence[tuple[int, int]]]
) -> list[tuple[int, int]]:
    """Window halo of a fused stage chain: the per-dim *sum* of the
    per-stage halos — each stage consumes its own halo off the dependency
    cone."""
    d = len(stage_halos[0])
    return [
        (
            sum(int(h[i][0]) for h in stage_halos),
            sum(int(h[i][1]) for h in stage_halos),
        )
        for i in range(d)
    ]


def stage_suffix_halos(
    stage_halos: Sequence[Sequence[tuple[int, int]]]
) -> list[list[tuple[int, int]]]:
    """Per-stage suffix halos of a chain: entry j (0-indexed) is the
    per-dim ``(Σ_{m>j} lo_m, Σ_{m>j} hi_m)`` — how far stage j+1..T's
    dependency cone still reaches past stage j+1's output.  Stage j+1's
    computed extent is ``tile + suffix[j]`` per dim, and the last entry is
    all-zero (the final stage computes the bare tile)."""
    T = len(stage_halos)
    d = len(stage_halos[0])
    out: list[list[tuple[int, int]]] = []
    for j in range(T):
        out.append(
            [
                (
                    sum(int(stage_halos[m][i][0]) for m in range(j + 1, T)),
                    sum(int(stage_halos[m][i][1]) for m in range(j + 1, T)),
                )
                for i in range(d)
            ]
        )
    return out


def frontier_depth(tile, stage_halos, j, sweep_axis, window_kind) -> int:
    """Sweep-axis depth of frontier j (stage j's output, read by stage
    j+1): the full suffix extent under ``"trapezoid"``, the band stage
    j+1's streaming read consumes (``t_s + lo_{j+1} + hi_{j+1}``) under
    ``"ring"`` — ``_frontier_depth`` of the reference."""
    t_s = int(tile[sweep_axis])
    if window_kind == "ring":
        lo, hi = stage_halos[j + 1][sweep_axis]
        return t_s + int(lo) + int(hi)
    if window_kind != "trapezoid":
        raise ValueError(f"unknown window_kind {window_kind!r}")
    lo, hi = stage_suffix_halos(stage_halos)[j][sweep_axis]
    return t_s + int(lo) + int(hi)


def _align16(n: int) -> int:
    return -(-int(n) // 16) * 16


def frontier_smem_bytes(
    tile: Sequence[int],
    sweep_axis: int,
    stage_halos: Sequence[Sequence[tuple[int, int]]],
    window_kind: str = "ring",
) -> int:
    """The frontier part of a chain CTA's shared memory, in bytes: one f32
    frontier per intermediate stage j (0 for a single stage), its cross
    extents ``tile + suffix halo`` times :func:`frontier_depth` rows, each
    rounded up to 16 bytes — what :func:`sweep_smem_bytes` adds to the
    input ring."""
    d = len(tile)
    s = int(sweep_axis)
    suffix = stage_suffix_halos(stage_halos)
    total = 0
    for j in range(len(stage_halos) - 1):
        ext = [int(t) + lo + hi for t, (lo, hi) in zip(tile, suffix[j])]
        depth = frontier_depth(tile, stage_halos, j, s, window_kind)
        total += _align16(depth * prod(ext[i] for i in range(d) if i != s) * 4)
    return total


def sweep_smem_bytes(
    tile: Sequence[int],
    sweep_axis: int,
    dtype_bytes: int,
    halo: Sequence[tuple[int, int]] | None = None,
    n_inputs: int = 1,
    pipelined: bool = False,
    stage_halos: Sequence[Sequence[tuple[int, int]]] | None = None,
    window_kind: str = "ring",
) -> int:
    """Dynamic shared memory of one sweep CTA, in bytes.

    Layout (each region rounded up to 16 bytes):

    * one input ring per RHS at the input dtype (``dtype_bytes``: 4 for
      f32, 2 for bf16, 1 for the int8 codes of a quantized input): the
      halo'd window's cross extents times ``t_s + h_s`` sweep rows, plus
      ``t_s`` rows of landing slab when ``pipelined`` (the next slab
      arrives while the current step computes);
    * for a chain (``stage_halos`` given, T >= 2), one f32 frontier per
      intermediate stage, whatever the stage's storage dtype (it holds the
      value already rounded through that dtype): stage j's cross extents
      ``tile + suffix halo`` times :func:`frontier_depth` rows.

    ``pipelined`` is the *effective* flag (the caller has already dropped
    it for a single sweep step or a zero sweep halo).  Raises
    ``ValueError`` above :data:`SMEM_BLOCK_LIMIT` (227 KB): a tile that
    does not fit is the caller's to change, never shrunk here."""
    d = len(tile)
    s = int(sweep_axis)
    if stage_halos is not None:
        halo = chain_halo(stage_halos)
    if halo is None or len(halo) != d:
        raise ValueError(f"pass a {d}-dim halo= or stage_halos=")
    win = [int(t) + int(lo) + int(hi) for t, (lo, hi) in zip(tile, halo)]
    t_s = int(tile[s])
    rows = win[s] + (t_s if pipelined else 0)
    cross = prod(win[i] for i in range(d) if i != s)
    total = int(n_inputs) * _align16(rows * cross * int(dtype_bytes))
    if stage_halos is not None:
        total += frontier_smem_bytes(tile, s, stage_halos, window_kind)
    if total > SMEM_BLOCK_LIMIT:
        raise ValueError(
            f"sweep launch needs {total} bytes of shared memory per block "
            f"(tile={tuple(int(t) for t in tile)}, sweep_axis={s}, "
            f"window_kind={window_kind!r}); the limit is {SMEM_BLOCK_LIMIT} "
            "bytes — pass a smaller tile"
        )
    return total


def apply_smem_bytes(
    tile: Sequence[int],
    sweep_axis: int,
    dtype_bytes: int,
    halo: Sequence[tuple[int, int]],
    strides: Sequence[int],
    n_inputs: int = 1,
    pipelined: bool = False,
    row_pad: int = 0,
) -> int:
    """Dynamic shared memory of one ``csrc/sweep_apply.cu`` CTA, in bytes.

    Axes are lifted to 3-D by leading axes of extent 1 (stride 0), and the
    two cross axes c0 < c1 are those other than the sweep axis.  One ring
    per RHS: ``t_s + h_s`` sweep rows (plus ``t_s`` landing rows when
    ``pipelined``, the effective flag) of the window's cross plane.  In a
    plane, window rows along c1 lie ``pitch`` elements apart: where c1 is
    the minor axis (``strides`` of the input), the least extent >= the
    window's c1 extent plus ``row_pad`` whose bytes equal the input's c0
    stride modulo 16, so that each shared row starts at its source row's
    alignment; else the c1 extent plus ``row_pad`` (room for a direct
    read to copy every 16-byte block its window row touches,
    ``kernels/sweep.py::_row_pad``).  Each plane is rounded up to 16
    bytes, and each ring has 16 bytes more for its start's alignment
    shift.  Raises
    ``ValueError`` above :data:`SMEM_BLOCK_LIMIT`, as
    :func:`sweep_smem_bytes` does."""
    d = len(tile)
    s = int(sweep_axis) + 3 - d
    tile3 = (1,) * (3 - d) + tuple(int(t) for t in tile)
    halo3 = ((0, 0),) * (3 - d) + tuple(halo)
    stride3 = (0,) * (3 - d) + tuple(int(v) for v in strides)
    win = [t + int(lo) + int(hi) for t, (lo, hi) in zip(tile3, halo3)]
    c0, c1 = [i for i in range(3) if i != s]
    pitch = win[c1] + int(row_pad)
    if stride3[c1] == 1:
        while (pitch - stride3[c0]) * int(dtype_bytes) % 16:
            pitch += 1
    plane = _align16(win[c0] * pitch * int(dtype_bytes))
    rows = win[s] + (tile3[s] if pipelined else 0)
    total = int(n_inputs) * _align16(rows * plane + 16)
    if total > SMEM_BLOCK_LIMIT:
        raise ValueError(
            f"sweep launch needs {total} bytes of shared memory per block "
            f"(tile={tuple(int(t) for t in tile)}, sweep_axis={sweep_axis}, "
            f"{n_inputs} inputs); the limit is {SMEM_BLOCK_LIMIT} bytes — "
            "pass a smaller tile"
        )
    return total


# -- the reference's traffic and compute models (copies) ----------------------

def surface_to_volume(
    tile: Sequence[int], halo: Sequence[tuple[int, int]]
) -> float:
    """Halo-weighted surface-to-volume ratio of an axis-aligned tile:

        Σ_i (h_lo_i + h_hi_i) · prod_{j≠i} T_j  /  prod_i T_i
    """
    vol = prod(tile)
    surf = sum(
        (lo + hi) * prod(t for j, t in enumerate(tile) if j != i)
        for i, (lo, hi) in enumerate(halo)
    )
    return surf / vol


def fused_halo(
    halo: Sequence[tuple[int, int]], time_steps: int
) -> list[tuple[int, int]]:
    """Halo of the T-step fused trapezoid: ``T·(h_lo, h_hi)`` per dim."""
    return [(lo * time_steps, hi * time_steps) for lo, hi in halo]


def tile_traffic_bytes(
    shape: Sequence[int],
    tile: Sequence[int],
    halo: Sequence[tuple[int, int]],
    dtype_bytes: int,
    sweep_axis: int | None = None,
    time_steps: int = 1,
    stage_halos: Sequence[Sequence[tuple[int, int]]] | None = None,
) -> int:
    """Device-memory bytes one operand's windows read in one pass of the
    engine (``time_steps`` applications fused into one sweep).

    ``sweep_axis=None`` charges the full halo on every tile;
    ``sweep_axis=s`` reuses the overlap of consecutive tiles along ``s``,
    so its halo is charged once per sweep column.  ``stage_halos`` prices
    a heterogeneous chain: the window halo is the per-stage sum."""
    halo = (
        chain_halo(stage_halos)
        if stage_halos is not None
        else fused_halo(halo, time_steps)
    )
    ntiles = [-(-n // t) for n, t in zip(shape, tile)]
    if sweep_axis is None:
        per_tile = prod(t + lo + hi for t, (lo, hi) in zip(tile, halo))
        return prod(ntiles) * per_tile * dtype_bytes
    s = sweep_axis
    cross = prod(
        t + lo + hi
        for i, (t, (lo, hi)) in enumerate(zip(tile, halo))
        if i != s
    )
    ncols = prod(nt for i, nt in enumerate(ntiles) if i != s)
    swept = ntiles[s] * tile[s] + halo[s][0] + halo[s][1]
    return ncols * swept * cross * dtype_bytes


def chain_flops(
    shape: Sequence[int],
    tile: Sequence[int],
    stage_points: Sequence[int],
    stage_halos: Sequence[Sequence[tuple[int, int]]],
    sweep_axis: int | None = None,
    streaming: bool = True,
) -> int:
    """Modelled multiply-add flops of one fused launch over the whole grid:
    stage j (``stage_points[j]`` taps, 2 flops each per output) computes
    ``tile + suffix_j`` per dim; ``streaming=True`` (the frontier kernel)
    computes the full extents at each column's first step and only the
    ``T_s`` new rows per stage after it, ``streaming=False`` (the
    recompute trapezoid) the full extents at every step."""
    shape = tuple(int(n) for n in shape)
    tile = tuple(int(t) for t in tile)
    suffix = stage_suffix_halos(stage_halos)
    ntiles = [-(-n // t) for n, t in zip(shape, tile)]
    flops = 0
    for j, s_j in enumerate(stage_points):
        ext = tuple(t + lo + hi for t, (lo, hi) in zip(tile, suffix[j]))
        full = prod(ext)
        if sweep_axis is None:
            per_region = prod(ntiles) * full
        else:
            ncols = prod(nt for i, nt in enumerate(ntiles) if i != sweep_axis)
            nswp = ntiles[sweep_axis]
            if streaming:
                cross = prod(e for i, e in enumerate(ext) if i != sweep_axis)
                per_col = full + (nswp - 1) * tile[sweep_axis] * cross
            else:
                per_col = nswp * full
            per_region = ncols * per_col
        flops += 2 * int(s_j) * per_region
    return flops


def _traffic_lower_bound(
    shape: tuple[int, ...], vmem_words: int, dtype_bytes: int, r: int
) -> float:
    """Isoperimetric lower bound on bytes moved (Eq. 7 with S = the fast
    memory's words); degenerate dims (extent 1) are collapsed."""
    eff = [n for n in shape if n > 1]
    if len(eff) < 2 or r == 0:
        return prod(shape) * dtype_bytes  # compulsory traffic only
    lb = lower_bound_loads(eff, vmem_words, p=1)
    return max(lb["bound"], lb["compulsory"]) * dtype_bytes


# -- the card ------------------------------------------------------------------

LINE_BYTES = 128  # an L2 line: the coalescing grain of a warp's row reads
# Shared memory the runtime reserves per resident block on sm_90.
SMEM_RESERVED_PER_BLOCK = 1024
ITEM_ROWS = 4  # kRows of both sweep kernels: sweep rows a thread holds


@dataclass(frozen=True)
class HopperDevice:
    """What the cost model needs to know of the card.

    ``apply_ctas_per_sm``/``chain_ctas_per_sm`` are the most CTAs of each
    kernel an SM holds whatever their shared memory (registers and
    ``__launch_bounds__``: the apply is built for 2, the chain runs 1);
    shared memory may cap them lower (:meth:`ctas_per_sm`).  On the card
    ``kernels.sweep.hopper_device`` reads the description from
    ``torch.cuda.get_device_properties`` and the kernels' occupancy
    queries; :data:`H100_SXM` holds the published figures."""

    name: str
    sm_count: int
    smem_per_block: int
    smem_per_sm: int
    l2_bytes: int
    hbm_bytes_per_s: float
    apply_threads: int
    apply_ctas_per_sm: int
    chain_threads: int
    chain_ctas_per_sm: int

    def key(self) -> tuple:
        """The description as a tuple (a plan request's ``hardware``)."""
        return dataclasses.astuple(self)

    @classmethod
    def from_key(cls, key: Sequence) -> "HopperDevice":
        kinds = [f.type for f in dataclasses.fields(cls)]
        cast = {"str": str, "int": int, "float": float}
        return cls(*(cast[k](v) for k, v in zip(kinds, key)))

    def threads(self, kernel: str) -> int:
        return self.apply_threads if kernel == "apply" else self.chain_threads

    def ctas_per_sm(self, kernel: str, smem_bytes: int) -> int:
        """CTAs of ``kernel`` resident on one SM at this much dynamic shared
        memory a CTA."""
        cap = (self.apply_ctas_per_sm if kernel == "apply"
               else self.chain_ctas_per_sm)
        fit = self.smem_per_sm // (int(smem_bytes) + SMEM_RESERVED_PER_BLOCK)
        return max(0, min(cap, fit))


# An NVIDIA H100 SXM as NVIDIA's data sheet gives it (132 SMs, 228 KB of
# shared memory an SM of which 227 KB a block, 50 MB of L2, 3.35 TB/s of
# HBM3), with the two sweep kernels' threads and register-bound residency.
H100_SXM = HopperDevice(
    name="NVIDIA H100 SXM (published figures)",
    sm_count=132,
    smem_per_block=SMEM_BLOCK_LIMIT,
    smem_per_sm=233472,
    l2_bytes=50 * 1024 * 1024,
    hbm_bytes_per_s=3.35e12,
    apply_threads=512,
    apply_ctas_per_sm=2,
    chain_threads=512,
    chain_ctas_per_sm=1,
)

# Issue cost of one round of a CTA's threads, seconds, with the card full:
# a round is each thread applying one tap to its 4-row item, or issuing one
# window copy (16 bytes, or one element when the sweep axis is the minor
# one).  Derived from device times of chip_smoke.py (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md §5, PR 16) through launch_model itself, both
# issue-bound there:
# * apply_f32_512, 0.6089 ms: 512³ f32, 13-point star, tile (8, 16, 32) at
#   sweep axis 0, 2 CTAs an SM: 512 columns in 2 waves, a column 64 steps
#   of 2 rounds × 13 taps (1,664) plus 5 + 63 × 3 = 194 copy rounds.
# * chain_T3_512, 3.835 ms: the same star 3 times fused, tile (4, 16, 32),
#   1 CTA an SM: 4 waves, a column (260 + 257 + 128) × 13 = 8,385 tap
#   rounds plus 10 + 127 × 3 = 391 copy rounds.
APPLY_ROUND_TAP_S = 0.6089e-3 / (2 * (1664 + 194))
CHAIN_ROUND_TAP_S = 3.835e-3 / (4 * (8385 + 391))


def minor_unit(dtype_bytes: int) -> int:
    """Minor-axis tile grain: the elements of one :data:`LINE_BYTES` line
    (32 f32, 64 bf16, 128 int8)."""
    return max(1, LINE_BYTES // max(int(dtype_bytes), 1))


def _aligned_candidates(n: int, unit: int, cap: int) -> list[int]:
    """Tile extents to consider for one dim: unit-aligned sizes plus n."""
    cands = {min(n, cap)}
    t = unit
    while t < min(n, cap):
        cands.add(t)
        t *= 2
    # Non-power-of-two aligned sizes help when n mod 2^k is bad.
    for mult in (3, 5, 6, 12, 24):
        v = unit * mult
        if v <= min(n, cap):
            cands.add(v)
    if n <= cap:
        cands.add(n)
    return sorted(cands)


def _free_candidates(n: int, cap: int) -> list[int]:
    """Unaligned extents (powers of two + n)."""
    cands = {min(n, cap)}
    t = 1
    while t < min(n, cap):
        cands.add(t)
        t *= 2
    if n <= cap:
        cands.add(n)
    return sorted(cands)


def candidate_tiles(
    shape: Sequence[int],
    max_tile_elems: int,
    aligned: bool = True,
    dtype_bytes: int = 4,
) -> list[tuple[int, ...]]:
    """Candidate tiles.  ``aligned=True`` takes minor extents in whole
    :data:`LINE_BYTES` lines (:func:`minor_unit` elements, or the whole
    extent) and the other extents from 1, 2, 4 ... 128 and the whole
    extent: a warp's row read then moves whole lines.  ``aligned=False``
    takes powers of two and the whole extent on every axis."""
    d = len(shape)
    per_dim: list[list[int]] = []
    for i, n in enumerate(shape):
        if not aligned:
            opts = _free_candidates(n, max_tile_elems)
        elif i == d - 1:
            opts = _aligned_candidates(n, minor_unit(dtype_bytes),
                                       max_tile_elems)
        else:
            opts = sorted({o for o in (1, 2, 4, 8, 16, 32, 64, 128, n)
                           if o <= n})
        per_dim.append(opts)
    return list(itertools.product(*per_dim))


def _padded_strides(shape, tile, halo) -> list[int]:
    """Element strides of a launch buffer: ``lo + ntiles·tile + hi`` per
    dim, contiguous."""
    ext = [lo + -(-int(n) // int(t)) * int(t) + hi
           for n, t, (lo, hi) in zip(shape, tile, halo)]
    strides = [1] * len(ext)
    for i in range(len(ext) - 2, -1, -1):
        strides[i] = strides[i + 1] * ext[i + 1]
    return strides


def launch_smem(
    kernel: str,
    shape: Sequence[int],
    tile: Sequence[int],
    sweep_axis: int,
    dtype_bytes: int,
    halo: Sequence[tuple[int, int]],
    stage_halos: Sequence[Sequence[tuple[int, int]]] | None = None,
    n_inputs: int = 1,
    pipelined: bool = True,
    window_kind: str = "ring",
) -> int:
    """Shared bytes per CTA of one launch of ``kernel`` (``"apply"`` or
    ``"chain"``), as the kernel carves them; ``pipelined`` is the caller's
    flag, dropped here as the wrappers drop it (one sweep step, or no
    sweep halo).  Raises ``ValueError`` above :data:`SMEM_BLOCK_LIMIT`."""
    s = int(sweep_axis)
    win = chain_halo(stage_halos) if stage_halos is not None else halo
    nswp = -(-int(shape[s]) // int(tile[s]))
    pipe = bool(pipelined) and nswp > 1 and win[s][0] + win[s][1] > 0
    if kernel == "apply":
        return apply_smem_bytes(tile, s, dtype_bytes, halo,
                                _padded_strides(shape, tile, halo),
                                n_inputs=n_inputs, pipelined=pipe)
    return sweep_smem_bytes(tile, s, dtype_bytes,
                            stage_halos=stage_halos or [list(halo)],
                            pipelined=pipe, window_kind=window_kind)


def launch_model(
    kernel: str,
    shape: Sequence[int],
    tile: Sequence[int],
    sweep_axis: int,
    stage_halos: Sequence[Sequence[tuple[int, int]]],
    stage_taps: Sequence[int],
    smem_bytes: int,
    in_bytes: int = 4,
    out_bytes: int | None = None,
    n_inputs: int = 1,
    device: HopperDevice = H100_SXM,
) -> dict:
    """Modelled time of one launch: ``max(bytes / bandwidth, issue) ×
    ceil(waves) / waves``.

    ``kernel="apply"``: one application, ``stage_halos`` holds the one
    window halo and ``stage_taps`` the taps of all ``n_inputs`` RHS
    together.  ``kernel="chain"``: stage j (``stage_halos[j]``,
    ``stage_taps[j]`` taps) computes its suffix extent at a column's first
    step and ``t_s`` new rows at each later one.  Bytes: each input's
    windows (:func:`tile_traffic_bytes`) plus the padded output.  Issue: a
    step's work is split into 4-row items over the CTA's threads, so a
    column costs Σ ceil(items / threads) × taps rounds, plus the rounds
    that copy its windows into shared memory (the whole window at the
    first step, ``t_s`` rows after it; 16 bytes a thread, one element when
    the sweep axis is the minor one), at :data:`APPLY_ROUND_TAP_S` or
    :data:`CHAIN_ROUND_TAP_S` each; columns run ``sm_count ×
    ctas_per_sm`` at a time.  Returns ``ms``, ``issue_ms``, ``bytes_ms``,
    ``ctas_per_sm`` and ``waves``."""
    s = int(sweep_axis)
    d = len(tile)
    tile = [int(t) for t in tile]
    ntiles = [-(-int(n) // t) for n, t in zip(shape, tile)]
    cols = prod(ntiles[i] for i in range(d) if i != s)
    nswp = ntiles[s]
    t_s = tile[s]
    threads = device.threads(kernel)

    def rounds(rows, plane):
        return -(-(-(-int(rows) // ITEM_ROWS) * int(plane)) // threads)

    if kernel == "apply":
        plane = prod(tile[i] for i in range(d) if i != s)
        per_col = nswp * rounds(t_s, plane) * int(sum(stage_taps))
        cost = APPLY_ROUND_TAP_S
        halo = stage_halos[0]
    else:
        per_col = 0
        for sfx, taps in zip(stage_suffix_halos(stage_halos), stage_taps):
            ext = [t + lo + hi for t, (lo, hi) in zip(tile, sfx)]
            plane = prod(ext[i] for i in range(d) if i != s)
            per_col += int(taps) * (
                rounds(ext[s], plane) + (nswp - 1) * rounds(t_s, plane))
        cost = CHAIN_ROUND_TAP_S
        halo = chain_halo(stage_halos)
    win = [t + lo + hi for t, (lo, hi) in zip(tile, halo)]
    cross = prod(win[i] for i in range(d) if i != s)
    per_copy = 1 if s == d - 1 else max(16 // int(in_bytes), 1)

    def copies(rows):
        units = -(-int(rows) * cross // per_copy) * int(n_inputs)
        return -(-units // threads)

    per_col += copies(win[s]) + (nswp - 1) * copies(t_s)
    out_bytes = in_bytes if out_bytes is None else out_bytes
    nbytes = (int(n_inputs)
              * tile_traffic_bytes(shape, tile, halo, in_bytes, s)
              + prod(nt * t for nt, t in zip(ntiles, tile)) * out_bytes)
    ctas = device.ctas_per_sm(kernel, smem_bytes)
    resident = device.sm_count * max(ctas, 1)
    waves = cols / resident
    issue_s = cols * per_col * cost / resident
    bytes_s = nbytes / device.hbm_bytes_per_s
    ms = max(issue_s, bytes_s) * (-(-cols // resident)) / waves * 1e3
    return {"ms": ms, "issue_ms": issue_s * 1e3, "bytes_ms": bytes_s * 1e3,
            "ctas_per_sm": ctas, "waves": waves}


@dataclass(frozen=True)
class TileChoice:
    tile: tuple[int, ...]
    grid: tuple[int, ...]
    traffic_bytes: int
    vmem_bytes: int  # shared bytes per CTA (the TPU's VMEM window)
    surface_to_volume: float
    lower_bound_bytes: float
    efficiency: float  # lower_bound / achieved traffic  (1.0 = optimal)
    sweep_axis: int | None = None
    modeled_ms: float = 0.0
    ctas_per_sm: int = 0
    waves: float = 0.0
    kernel: str = "apply"

    def __post_init__(self):
        # The isoperimetric bound is a true lower bound on any schedule, so
        # the modelled traffic of a concrete legal schedule can never beat it.
        assert 0.0 <= self.efficiency <= 1.0, (
            f"efficiency {self.efficiency} > 1: traffic model fell below the "
            f"isoperimetric lower bound (tile={self.tile})"
        )


def _ms_key(ms: float) -> float:
    """Modelled times equal to 9 significant digits are ties."""
    return float(f"{ms:.9g}")


def select_tile(
    shape: Sequence[int],
    halo: Sequence[tuple[int, int]],
    dtype_bytes: int = 4,
    vmem_budget: int = SMEM_BLOCK_LIMIT,
    sweep_axis: int | str = "auto",
    aligned: bool = True,
    prefetch: bool = True,
    extra_tiles: Sequence[Sequence[int]] | None = None,
    stage_halos: Sequence[Sequence[tuple[int, int]]] | None = None,
    window_kind: str = "ring",
    kernel: str = "apply",
    stage_taps: Sequence[int] = (1,),
    n_inputs: int = 1,
    out_bytes: int | None = None,
    device: HopperDevice = H100_SXM,
    exclude_sweep_axis: int | None = None,
) -> TileChoice:
    """The tile of least modelled time for one launch of ``kernel``.

    ``sweep_axis="auto"`` tries every axis of extent > 1 (an int forces
    one); the reference's per-tile-halo option (``None``) is not
    enumerated: the port's launch realises it as axis 0.
    ``exclude_sweep_axis`` (a column-sharded launch's shard axis) drops one
    axis from the ``"auto"`` enumeration: a shard sweeps within its own
    column slab, never along the partitioned axis.  A tile is
    feasible when :func:`launch_smem` fits ``min(vmem_budget,
    device.smem_per_block)`` and at least one CTA fits an SM.  Ties go to
    less traffic, then fewer sweep steps, then the lower axis, then less
    shared memory.  ``extra_tiles`` are scored alongside the candidates
    under every axis (the planner's lattice-informed boxes).  ``halo`` is
    the apply's window halo (for a chain, the per-application union, used
    for the surface-to-volume figure and the bound's radius);
    ``stage_halos`` the chain's per-stage halos (a chain launch of one
    stage without it takes ``[halo]``)."""
    shape = tuple(int(n) for n in shape)
    halo = [(int(lo), int(hi)) for lo, hi in halo]
    if kernel == "chain" and stage_halos is None:
        stage_halos = [halo]
    if stage_halos is not None:
        stage_halos = [
            [(int(lo), int(hi)) for lo, hi in h] for h in stage_halos
        ]
    budget = min(int(vmem_budget), device.smem_per_block)
    max_elems = max(budget // dtype_bytes, 1)
    extras = [
        tuple(int(t) for t in e)
        for e in (extra_tiles or [])
        if len(e) == len(shape) and all(1 <= int(t) for t in e)
    ]
    if sweep_axis == "auto":
        free = [i for i in range(len(shape)) if i != exclude_sweep_axis]
        axes = [i for i in free if shape[i] > 1] or free[:1]
    else:
        axes = [int(sweep_axis)]
    window = chain_halo(stage_halos) if kernel == "chain" else halo
    r = max(max(lo, hi) for lo, hi in halo)
    lb = _traffic_lower_bound(shape, max_elems, dtype_bytes, r)
    cands = candidate_tiles(shape, max_elems, aligned, dtype_bytes)
    seen = set(cands)
    cands = cands + [t for t in extras if t not in seen]
    best, best_key = None, None
    for rank, axis in enumerate(axes):
        for tile in cands:
            try:
                smem = launch_smem(kernel, shape, tile, axis, dtype_bytes,
                                   halo, stage_halos, n_inputs, prefetch,
                                   window_kind)
            except ValueError:
                continue
            if smem > budget or device.ctas_per_sm(kernel, smem) < 1:
                continue
            model = launch_model(
                kernel, shape, tile, axis,
                stage_halos if kernel == "chain" else [halo], stage_taps,
                smem, dtype_bytes, out_bytes, n_inputs, device)
            traffic = tile_traffic_bytes(shape, tile, window, dtype_bytes,
                                         axis)
            nswp = -(-shape[axis] // tile[axis])
            key = (_ms_key(model["ms"]), traffic, nswp, rank, smem)
            if best_key is not None and key >= best_key:
                continue
            eff = lb / traffic if traffic else 1.0
            assert eff <= 1.0 + 1e-9, (
                f"traffic model below isoperimetric bound: tile={tile} "
                f"axis={axis} traffic={traffic} lb={lb}"
            )
            best_key = key
            best = TileChoice(
                tile=tile,
                grid=tuple(-(-n // t) for n, t in zip(shape, tile)),
                traffic_bytes=traffic,
                vmem_bytes=smem,
                surface_to_volume=surface_to_volume(tile, halo),
                lower_bound_bytes=lb,
                efficiency=min(eff, 1.0),
                sweep_axis=axis,
                modeled_ms=model["ms"],
                ctas_per_sm=model["ctas_per_sm"],
                waves=model["waves"],
                kernel=kernel,
            )
    if best is None:
        raise ValueError(
            f"no tile of {shape} (halo {halo}) fits {budget} bytes of "
            f"shared memory per CTA for the {kernel} kernel"
        )
    return best
