"""Launch geometry of the sweep kernels: halos, chain cones, shared memory.

``dtype_itemsize``, ``halo_from_offsets``, ``chain_halo`` and
``stage_suffix_halos`` are copies of the JAX package's ``core/tiling``
helpers, so that the port's launch geometry equals the reference's on the
same inputs.  The TPU cost model (VMEM budget, lane/sublane grains, tile
search) stays out: the Hopper planner is a slice of its own.

``sweep_smem_bytes`` and ``apply_smem_bytes`` are new: they reckon one
CTA's dynamic shared memory from the same geometry, laid out exactly as
``csrc/sweep_chain.cu`` and ``csrc/sweep_apply.cu`` carve it.
"""

from __future__ import annotations

from math import prod
from typing import Sequence

import numpy as np

__all__ = [
    "SMEM_BLOCK_LIMIT",
    "apply_smem_bytes",
    "chain_halo",
    "dtype_itemsize",
    "frontier_depth",
    "halo_from_offsets",
    "stage_suffix_halos",
    "sweep_smem_bytes",
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
        suffix = stage_suffix_halos(stage_halos)
        for j in range(len(stage_halos) - 1):
            ext = [
                int(t) + lo + hi for t, (lo, hi) in zip(tile, suffix[j])
            ]
            depth = frontier_depth(tile, stage_halos, j, s, window_kind)
            total += _align16(
                depth * prod(ext[i] for i in range(d) if i != s) * 4
            )
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
) -> int:
    """Dynamic shared memory of one ``csrc/sweep_apply.cu`` CTA, in bytes.

    Axes are lifted to 3-D by leading axes of extent 1 (stride 0), and the
    two cross axes c0 < c1 are those other than the sweep axis.  One ring
    per RHS: ``t_s + h_s`` sweep rows (plus ``t_s`` landing rows when
    ``pipelined``, the effective flag) of the window's cross plane.  In a
    plane, window rows along c1 lie ``pitch`` elements apart: where c1 is
    the minor axis (``strides`` of the padded input), the least extent >=
    the window's c1 extent whose bytes equal the input's c0 stride modulo
    16, so that each shared row starts at its source row's alignment;
    else the c1 extent.  Each plane is rounded up to 16 bytes, and each
    ring has 16 bytes more for its start's alignment shift.  Raises
    ``ValueError`` above :data:`SMEM_BLOCK_LIMIT`, as
    :func:`sweep_smem_bytes` does."""
    d = len(tile)
    s = int(sweep_axis) + 3 - d
    tile3 = (1,) * (3 - d) + tuple(int(t) for t in tile)
    halo3 = ((0, 0),) * (3 - d) + tuple(halo)
    stride3 = (0,) * (3 - d) + tuple(int(v) for v in strides)
    win = [t + int(lo) + int(hi) for t, (lo, hi) in zip(tile3, halo3)]
    c0, c1 = [i for i in range(3) if i != s]
    pitch = win[c1]
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
