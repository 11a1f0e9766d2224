"""Causal depthwise conv1d + silu — the Mamba2 block's conv — on the card.

Source: ``src/repro/kernels/conv1d.py:44`` ``_conv_call`` (its ``body``
at line 54), a Pallas TPU kernel that sweeps tiles of ``tile_s`` tokens
per batch row and shifts the W-1-token halo inside VMEM.  Here it is
``csrc/conv1d.cu``: each warp owns a run of at most 32 tokens of one tile
across 32 · V channels, reads its own halo rows from ``x`` or ``state``,
and keeps the last W inputs in registers while each lane walks down its
run with the next rows' loads in flight (the design note is in the
source).  The wrapper picks V, the channels a lane moves at once, from C
and the buffers' alignment (:func:`_vec`).

    out[b, s, c] = silu(Σ_t f32(x[b, s-W+1+t, c]) · f32(w[t, c]) + f32(bias[c]))

accumulated in f32 in that order from 0 and stored in x's dtype (f32 or
bf16); rows before s = 0 come from ``state`` (B, W-1, C) when it is given,
else zeros.

Bound: bytes.  Mamba2-2.7B's prefill conv (batch 4, 2048 tokens,
C = 5120 + 2·128 = 5376, bf16) reads x and writes out once, 2 × 88.08 MB,
0.0526 ms at 3.35 TB/s; it runs once per layer, 64 times a prefill.

:func:`causal_conv1d_launch` is the kernel's wrapper: on a CUDA tensor it
launches the kernel (and counts the launch in ``repro_torch.obs.totals()``
as ``launches.conv1d``)
or raises; on a CPU tensor it runs :func:`causal_conv1d_plain`, the plain
PyTorch version beside it (``_prepend_halo`` + the unrolled f32 loop +
silu), which the tests use.  :func:`causal_conv1d` is the entry point with
the reference's signature and its custom VJP as a ``torch.autograd.Function``
whose backward, :func:`causal_conv1d_vjp`, is plain torch math, as the
reference's is plain jnp.  Training runs each layer under activation
checkpointing, so a step launches the kernel twice a layer: the forward
and its recompute before the backward.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import obs, resolve_device
from . import _build

_LAUNCHES = obs.counter("launches.conv1d")

__all__ = [
    "causal_conv1d",
    "causal_conv1d_launch",
    "causal_conv1d_plain",
    "causal_conv1d_vjp",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_WIDTH = 4  # kMaxWidth of conv1d.cu: the kernel is unrolled per width
_RUN = 32  # kRun of conv1d.cu: tokens of one warp's run


def _silu(acc: torch.Tensor) -> torch.Tensor:
    # jax.nn.silu's form; on the card ATen's f32 sigmoid is
    # 1 / (1 + exp(-a)), the expression the kernel evaluates.
    return acc * torch.sigmoid(acc)


def _prepend_halo(x, conv_w, state, tile_s):
    """Concat the W-1 halo (zeros or the previous tail) and round S up to
    a multiple of the tile — the reference's ``_prepend_halo``."""
    b, s, c = x.shape
    halo = conv_w.shape[0] - 1
    tile_s = min(tile_s, s)
    pad_s = -(-s // tile_s) * tile_s
    if state is None:
        head = torch.zeros((b, halo, c), dtype=x.dtype, device=x.device)
    else:
        head = state.to(x.dtype)
    tail = torch.zeros((b, pad_s - s, c), dtype=x.dtype, device=x.device)
    return torch.cat([head, x, tail], dim=1), tile_s


def causal_conv1d_plain(x, conv_w, conv_b, state=None):
    """The kernel's function in plain PyTorch: the unrolled f32 loop over
    the halo'd input, then silu, stored in x's dtype.  The result does not
    depend on the tile, so the whole sequence is one tile: no round-up
    rows (on the CPU, ATen's vectorized sigmoid can differ by an ulp with
    an element's place in the buffer, so padding would change results)."""
    b, s, c = x.shape
    xp, _ = _prepend_halo(x, conv_w, state, s)
    wf = conv_w.float()
    acc = torch.zeros((b, s, c), dtype=torch.float32, device=x.device)
    for t in range(conv_w.shape[0]):
        acc = acc + xp[:, t:t + s, :].float() * wf[t]
    acc = acc + conv_b.float()
    return _silu(acc).to(x.dtype)


def _check(x, conv_w, conv_b, state, tile_s) -> None:
    if x.ndim != 3:
        raise ValueError(f"x must be (B, S, C), got shape {tuple(x.shape)}")
    b, s, c = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the conv kernel takes f32 or bf16 x, got {x.dtype}")
    if conv_w.ndim != 2 or conv_w.shape[1] != c or conv_w.shape[0] < 1:
        raise ValueError(f"conv_w must be (W, {c}), got {tuple(conv_w.shape)}")
    if tuple(conv_b.shape) != (c,):
        raise ValueError(f"conv_b must be ({c},), got {tuple(conv_b.shape)}")
    width = conv_w.shape[0]
    if state is not None and tuple(state.shape) != (b, width - 1, c):
        raise ValueError(
            f"state must be ({b}, {width - 1}, {c}), got {tuple(state.shape)}"
        )
    if not conv_w.is_floating_point() or not conv_b.is_floating_point():
        raise TypeError("conv_w and conv_b must be floating point")
    if int(tile_s) < 1:
        raise ValueError(f"tile_s must be positive, got {tile_s}")
    for t in (conv_w, conv_b, state):
        if t is not None and t.device != x.device:
            raise ValueError("x, conv_w, conv_b and state must share a device")


_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
]
_THREADS = 256  # kThreads of conv1d.cu: threads a block, 8 warps
_RUN = 32  # kRun of conv1d.cu: rows of one warp's run
# Channels a thread at most: 16 bytes of f32, 8 of bf16.  16 bytes of bf16
# (8 channels) took more registers, fewer warps an SM and more time on the
# card (PERF.md §6, scripts/kernel_variants.py).
_VEC = 4


def _vec(c, x, out, state=None) -> int:
    """Channels a thread moves at once: the most, from :data:`_VEC` down
    by halves to one, that C is a multiple of and that x, out and state
    all start aligned to."""
    es = x.element_size()
    bufs = [t for t in (x, out, state) if t is not None]
    v = _VEC
    while v > 1 and not (c % v == 0 and all(
            t.data_ptr() % (v * es) == 0 for t in bufs)):
        v //= 2
    return v


def grid_blocks(b, s, c, tile_s, vec) -> int:
    """Blocks of one launch: the (batch row, tile, run, slab) items, one
    a warp, ``_THREADS // 32`` warps a block."""
    tile = min(int(tile_s), s)
    items = b * -(-s // tile) * -(-tile // _RUN) * -(-(c // vec) // 32)
    return -(-items // (_THREADS // 32))


def _lib():
    lib = _build.load("conv1d")
    if not getattr(lib, "typed", False):
        lib.conv1d_launch.restype = ctypes.c_int
        lib.conv1d_launch.argtypes = _ARGTYPES
        lib.conv1d_occupancy.restype = ctypes.c_int
        lib.conv1d_occupancy.argtypes = [ctypes.c_int] * 3
        lib.typed = True
    return lib


def occupancy(dtype, width, vec) -> int:
    """Blocks of the conv kernel's (dtype, width, vec) variant resident on
    one SM of the current card (CUDA's occupancy query).  Needs the card;
    launches nothing."""
    n = _lib().conv1d_occupancy(_DTYPE_CODE[dtype], int(width), int(vec))
    if n < 0:
        raise RuntimeError(f"conv1d_occupancy: error {-n}")
    return n


def causal_conv1d_launch(x, conv_w, conv_b, tile_s, state=None):
    """The kernel's wrapper.  x: (B, S, C) f32 or bf16; conv_w: (W, C);
    conv_b: (C,), each f32 or bf16; state: (B, W-1, C) or None; ``tile_s``
    tokens per tile.  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel on the current stream or raises."""
    _check(x, conv_w, conv_b, state, tile_s)
    dev = x.device
    if dev.type == "cpu":
        return causal_conv1d_plain(x, conv_w, conv_b, state)
    if dev.type != "cuda":
        raise RuntimeError(f"causal_conv1d: unsupported device {dev}")
    b, s, c = x.shape
    width = conv_w.shape[0]
    if width > _MAX_WIDTH:
        raise ValueError(
            f"the conv kernel takes widths 1..{_MAX_WIDTH}, got {width}"
        )
    if not x.is_contiguous():
        raise ValueError("the conv kernel takes a contiguous x")
    # The kernel widens f32 or bf16 weights and bias itself, the exact
    # widening the reference's f32 multiply-adds apply; another float dtype
    # is widened here first.  state goes in x's dtype.
    w = conv_w if conv_w.dtype in _DTYPE_CODE else conv_w.float()
    bias = conv_b if conv_b.dtype in _DTYPE_CODE else conv_b.float()
    w, bias = w.contiguous(), bias.contiguous()
    st = None if state is None else state.to(x.dtype).contiguous()
    out = torch.empty_like(x)
    vec = _vec(c, x, out, st)
    tile_s = min(int(tile_s), s)
    stream = torch.cuda.current_stream(dev)
    with torch.cuda.device(dev):
        rc = _lib().conv1d_launch(
            x.data_ptr(), None if st is None else st.data_ptr(),
            w.data_ptr(), bias.data_ptr(), out.data_ptr(), b, s, c, width,
            tile_s, _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype],
            _DTYPE_CODE[bias.dtype], vec, stream.cuda_stream,
        )
    if rc == -2:
        raise RuntimeError(
            f"causal_conv1d: the kernel refused shape {(b, s, c)}, width "
            f"{width}, tile_s {tile_s} (S at most 2^31 - 2^16 - tile_s, C "
            f"at most 2^31 / 36)"
        )
    if rc != 0:
        raise RuntimeError(f"causal_conv1d: CUDA launch failed with cudaError {rc}")
    obs.count(_LAUNCHES)
    return out


def causal_conv1d_vjp(x, conv_w, conv_b, g):
    """The reference's backward of the conv (``conv1d.py:151-178``), plain
    torch as the reference's is plain jnp: recompute the pre-activation in
    f32, apply silu', then the transposed (anti-causal) correlation.
    Returns ``(dx, dw, db)`` in the dtypes of ``x``, ``conv_w``,
    ``conv_b``."""
    b, s, c = x.shape
    width = conv_w.shape[0]
    halo = width - 1
    wf = conv_w.float()
    full = torch.cat(
        [torch.zeros((b, halo, c), dtype=x.dtype, device=x.device), x], 1
    )
    pre = torch.zeros((b, s, c), dtype=torch.float32, device=x.device)
    for i in range(width):
        pre = pre + full[:, i:i + s, :].float() * wf[i]
    pre = pre + conv_b.float()
    sig = torch.sigmoid(pre)
    gpre = g.float() * sig * (1.0 + pre * (1.0 - sig))
    gp = torch.cat([gpre, gpre.new_zeros((b, halo, c))], 1)
    dx = torch.zeros((b, s, c), dtype=torch.float32, device=x.device)
    for i in range(width):
        dx = dx + gp[:, halo - i:halo - i + s, :] * wf[i]
    dw = torch.stack([
        torch.einsum("btc,btc->c", gpre, full[:, i:i + s, :].float())
        for i in range(width)
    ])
    db = gpre.sum(dim=(0, 1))
    return dx.to(x.dtype), dw.to(conv_w.dtype), db.to(conv_b.dtype)


class _ConvGrad(torch.autograd.Function):
    """The reference's custom VJP (``conv1d.py:141-181``): the forward is
    the kernel, the backward :func:`causal_conv1d_vjp`."""

    @staticmethod
    def forward(ctx, x, conv_w, conv_b, tile_s):
        ctx.save_for_backward(x, conv_w, conv_b)
        return causal_conv1d_launch(x, conv_w, conv_b, tile_s)

    @staticmethod
    def backward(ctx, g):
        return (*causal_conv1d_vjp(*ctx.saved_tensors, g), None)


@functools.lru_cache(maxsize=512)
def _planned_tile_s(seq: int, channels: int, width: int, dtype_bytes: int,
                    hardware: tuple) -> int:
    """Token tile from the plan compiler, as the reference's
    ``_planned_tile_s``: the conv is a (S, C) grid with halo (W-1, 0), and
    the tile is the plan's extent along S — rounded up to whole 32-token
    runs, since the kernel's runs never cross a tile's end (so the tile
    changes only the padding).  The planner's persistent cache and this
    per-process memo make the serving-path repeat O(1)."""
    from ..plan import default_planner

    offs = tuple((-i, 0) for i in range(width))
    plan = default_planner().plan(
        shape=(seq, channels), offsets=(offs,), dtype_bytes=dtype_bytes,
        n_operands=2, hardware=hardware,
    )
    return -(-int(plan.tile[0]) // _RUN) * _RUN


def causal_conv1d(x, conv_w, conv_b, tile_s=None, state=None, device=None):
    """x: (B, S, C); conv_w: (W, C); conv_b: (C,).  Causal, silu-activated
    (matches ``models.ssm._causal_conv``).  ``state``: optional (B, W-1, C)
    tail of the previous sequence, used as the leading halo (serving path;
    not differentiated).  Without ``state`` the call is differentiable
    through the reference's custom VJP.

    Inputs (tensors or arrays) go to ``device``: ``None`` means the card,
    ``"cpu"`` runs the plain version.  ``tile_s=None`` asks the plan
    compiler for the card the tensors are on (:func:`_planned_tile_s`)."""
    dev = resolve_device(device)
    x, conv_w, conv_b = (torch.as_tensor(t).to(dev) for t in (x, conv_w, conv_b))
    if tile_s is None:
        from ..core.tiling import H100_SXM
        from .sweep import hopper_device

        hw = hopper_device(dev) if dev.type == "cuda" else H100_SXM
        tile_s = _planned_tile_s(int(x.shape[1]), int(x.shape[2]),
                                 int(conv_w.shape[0]), x.element_size(),
                                 hw.key())
    if state is None:
        return _ConvGrad.apply(x, conv_w, conv_b, int(tile_s))
    return causal_conv1d_launch(
        x, conv_w, conv_b, int(tile_s), torch.as_tensor(state).to(dev)
    )

