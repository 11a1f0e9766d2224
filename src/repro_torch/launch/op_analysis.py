"""Operation counts of an eager PyTorch program, and a model of its
collective traffic: the port's counterpart, by role, of the JAX package's
``launch/hlo_analysis.py``.

There is no HLO in PyTorch.  :class:`OpCounter` is a
``TorchDispatchMode`` that counts the program as it runs, on ``meta``,
CPU or CUDA tensors alike:

    flops      — 2 · |result| · |contraction| for each ``mm``, ``bmm``,
                 ``addmm``, ``baddbmm`` (and ``mv``/``dot``) and each
                 convolution (a convolution's backward counts its input
                 and weight gradients as one convolution each).
                 ``einsum`` and ``matmul`` reach these, so they are
                 counted through them.
    hbm_bytes  — Σ (operand + result bytes) over every op that is not a
                 view (views move nothing).  Eager PyTorch runs each op as
                 its own kernel, so unlike the reference nothing is
                 assumed fused.

Forward, checkpoint recompute and backward are all dispatched, so the
counts need no loop trip counts: the reference's while-loop roll-up
(``hlo_analysis.py``'s ``roll``) has no counterpart here.

``wire_bytes`` cannot be read from a program that one process runs on one
device.  :func:`model_wire_bytes` models it from the shardings of
:mod:`repro_torch.parallel.sharding`, with the ring factors of the
reference's ``launch/roofline.py`` (:func:`ring_wire`), in four terms
named as the reference names its collectives: an all-gather of each
fsdp-sharded parameter at each forward use and at its recompute, a
reduce-scatter of its gradient, an all-reduce of each gradient that the
data axes replicate, and two all-reduces a block of the residual stream's
per-device bytes where 'tensor' maps to a mesh axis of size > 1 (forward,
recompute and backward); an all-to-all of the MoE dispatch buffers where
'expert' maps.  **This is a model, not a measurement.**

:class:`LiveBytes` follows the storages that ops allocate while it is
active and keeps their peak: the dry-run's stand-in for XLA's
``temp_size_in_bytes``.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from math import ceil, prod

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..parallel.sharding import Sharding, logical_sharding, map_specs

__all__ = [
    "LiveBytes",
    "OpCost",
    "OpCounter",
    "count_ops",
    "model_wire_bytes",
    "ring_wire",
]

aten = torch.ops.aten


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _mm_flops(args, out) -> float:
    """mm/bmm/mv/dot: the contraction is the first operand's last dim."""
    return 2.0 * out.numel() * args[0].shape[-1]


def _addmm_flops(args, out) -> float:
    """addmm/baddbmm: ``bias + a @ b``, the contraction ``a``'s last dim."""
    return 2.0 * out.numel() * args[1].shape[-1]


def _conv_macs_per(x, out, w, transposed: bool) -> float:
    """Multiply-adds of a convolution: each output element contracts over
    (in channels a group) × (kernel extent); for a transposed convolution
    (weight (in, out/groups, k...)) each *input* element spreads over
    (out channels a group) × (kernel extent)."""
    k = prod(w.shape[2:])
    return (x.numel() if transposed else out.numel()) * w.shape[1] * k


def _conv_flops(args, out) -> float:
    return 2.0 * _conv_macs_per(args[0], out, args[1], bool(args[6]))


def _conv_backward_flops(args, out) -> float:
    """The input and the weight gradient (where ``output_mask`` asks for
    them) each cost the forward's flops."""
    grad_out, x, w, transposed, mask = (args[0], args[1], args[2],
                                        bool(args[7]), args[10])
    one = 2.0 * _conv_macs_per(x, grad_out, w, transposed)
    return one * (int(bool(mask[0])) + int(bool(mask[1])))


_FLOPS = {
    aten.mm: _mm_flops,
    aten.bmm: _mm_flops,
    aten.mv: _mm_flops,
    aten.dot: _mm_flops,
    aten.addmm: _addmm_flops,
    aten.baddbmm: _addmm_flops,
    aten.convolution: _conv_flops,
    aten.convolution_backward: _conv_backward_flops,
}


@dataclass
class OpCost:
    """Counted (or modelled) totals, the fields of the reference's
    ``HloCost``."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    wire_bytes: float = 0.0
    per_coll: dict = field(default_factory=dict)
    per_op: dict = field(default_factory=dict)


class _Decomposing(TorchDispatchMode):
    """A dispatch mode that sees composite ops through their parts.  Under
    ``torch.inference_mode`` (serving) a composite op such as ``matmul``
    or ``einsum`` reaches the mode whole; it is decomposed under the mode,
    so that the ``mm``/``bmm`` it runs are what the mode sees, as under
    autograd."""

    def _decomposed(self, func, args, kwargs):
        with self:
            return func.decompose(*args, **kwargs)


class OpCounter(_Decomposing):
    """Counts flops and bytes of every op dispatched while active
    (``with OpCounter() as c: ...``; then ``c.cost``)."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._decomposed(func, args, kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        fl = _FLOPS.get(packet)
        if fl is not None:
            first = out[0] if isinstance(out, (tuple, list)) else out
            f = fl(args, first)
            self.cost.flops += f
            name = packet.__name__
            self.cost.per_op[name] = self.cost.per_op.get(name, 0.0) + f
        if not func.is_view:
            leaves, _ = tree_flatten((args, kwargs, out))
            self.cost.hbm_bytes += sum(_nbytes(t) for t in leaves
                                       if isinstance(t, torch.Tensor))
        return out


class LiveBytes(_Decomposing):
    """The peak of live storage bytes that ops allocate while active.

    A storage first seen as an op's input existed before and is not
    counted; one first seen as an op's output is new and counts until it
    is freed.  :meth:`resize` re-prices a new storage (the dry-run prices
    a gradient at its per-device share)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._sizes: dict[int, int] = {}   # counted storages, by identity
        self._known: dict[int, object] = {}  # identity -> weakref

    def _key(self, t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def _forget(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)
        self._known.pop(key, None)

    def _see(self, t: torch.Tensor, new: bool) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known:
            return
        self._known[key] = weakref.ref(st, lambda _, k=key: self._forget(k))
        if new:
            n = st.nbytes()
            self._sizes[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)

    def resize(self, t: torch.Tensor, nbytes: int) -> None:
        key = self._key(t)
        if key in self._sizes:
            self.live += nbytes - self._sizes[key]
            self._sizes[key] = nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._decomposed(func, args, kwargs)
        if out is not NotImplemented:
            return out
        for t in tree_flatten((args, kwargs))[0]:
            if isinstance(t, torch.Tensor):
                self._see(t, new=False)
        out = func(*args, **kwargs)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._see(t, new=True)
        return out


def count_ops(fn, *args, **kwargs) -> tuple[object, OpCost]:
    """``fn(*args, **kwargs)`` under an :class:`OpCounter`: its result and
    the counted cost."""
    with OpCounter() as c:
        out = fn(*args, **kwargs)
    return out, c.cost


# ---------------------------------------------------------------------------
# Collective traffic: the reference's ring factors, and the model.
# ---------------------------------------------------------------------------

def ring_wire(op: str, nbytes: float, g: int) -> float:
    """Per-device wire bytes of one collective over a group of ``g``, as
    the reference's ``roofline.py`` counts them: ``nbytes`` is the
    all-gather's output, the reduce-scatter's input, the all-reduce's and
    the all-to-all's operand, the permute's payload."""
    ring = (g - 1) / g if g > 1 else 0.0
    if op == "all-reduce":
        return 2.0 * ring * nbytes
    if op in ("all-gather", "reduce-scatter", "all-to-all"):
        return ring * nbytes
    if op == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective {op!r}")


def model_wire_bytes(cfg, param_specs, mesh, rules, *, kind: str,
                     local_batch: int, seq: int) -> OpCost:
    """Modelled per-device collective bytes of one step of ``kind``
    (``train``, ``prefill`` or ``decode``, ``seq`` tokens a sequence, one
    for decode) at ``local_batch`` sequences a device.  Returns an
    :class:`OpCost` with only ``wire_bytes`` and ``per_coll`` set."""
    cost = OpCost()

    def add(op, nbytes, g, times=1):
        w = ring_wire(op, nbytes, g) * times
        if w:
            cost.wire_bytes += w
            cost.per_coll[op] = cost.per_coll.get(op, 0.0) + w

    def size(logical: str) -> int:
        """The mesh's extent over the axes a logical name maps to."""
        return prod(mesh.shape[a] for a in rules.get(logical, ())
                    if a in mesh.axis_names)

    train = kind == "train"
    passes = (2 if cfg.remat else 1) if train else 1  # forward (+ recompute)
    # activation collectives run in each forward pass and in the backward
    act_times = 2 * (passes + (1 if train else 0))
    dp = size("batch")
    fsdp_axes = set(rules.get("fsdp", ()))

    def per_param(spec):
        sh = logical_sharding(spec.axes, mesh, spec.shape, rules)
        local = prod(sh.shard_shape(spec.shape)) * spec.dtype.itemsize
        g = 1
        for entry in sh.spec:
            axes = Sharding.axes_of(entry)
            if axes and set(axes) <= fsdp_axes:
                g *= prod(mesh.shape[a] for a in axes)
        if g > 1:
            gathered = local * g
            add("all-gather", gathered, g, passes)
            if train:
                add("reduce-scatter", gathered, g)
        elif train:
            add("all-reduce", local, dp)

    map_specs(per_param, param_specs)

    cd = cfg.compute_dtype.itemsize
    tokens = local_batch * seq
    tp = size("tensor")
    if tp > 1:
        blocks = cfg.n_layers
        if cfg.attn_every:
            blocks += cfg.n_layers // cfg.attn_every
        resid = tokens * cfg.d_model * cd
        add("all-reduce", resid, tp, blocks * act_times)
        if cfg.enc_layers and kind != "decode":
            enc = local_batch * cfg.frontend_len * cfg.d_model * cd
            add("all-reduce", enc, tp, cfg.enc_layers * act_times)
    ep = size("expert")
    if cfg.moe is not None and ep > 1:
        m = cfg.moe
        cap = max(int(ceil(tokens * m.top_k / m.n_experts
                           * m.capacity_factor)), 4)
        disp = m.n_experts * cap * cfg.d_model * cd
        add("all-to-all", disp, ep, cfg.n_layers * act_times)
    return cost
