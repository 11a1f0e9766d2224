"""AdamW + schedules + clipping, as plain functions on tensors.

The JAX package's ``optim/optimizer.py`` with its formulas and its order
of operations: the clip scale ``min(1, clip_norm / (‖g‖ + 1e-9))``, bias
correction ``1 - b ** count`` in f32, and decoupled weight decay
``step + wd · p``.  ``torch.optim.AdamW`` is not used: it decays every
tensor and rounds in another order.

A tree here is a flat mapping ``{name: tensor}``; the trainer passes the
model's ``named_parameters()`` and their gradients.  The optimizer state
is ``{"m": {name: f32}, "v": {name: f32}, "count": int32 0-dim}``.

Which leaves are decayed is the reference's rule, ``p.ndim > 1`` **of the
reference's tree**, where the layers' leaves are stacked (L, ...).  The
port holds each layer's leaves apart, so ``ln``, ``dt_bias``, ``A_log``,
``D``, ``conv_b`` and ``norm_w`` are 1-D tensors here and still decayed;
:func:`decay_mask` reads the rank from the reference's spec tree.

:func:`adamw_update` updates parameters and moments in place (the
reference returns new trees): at Mamba2-2.7B's size a second copy of the
parameters would cost 10.8 GB of device memory.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping

import torch

from ..models.layers import flatten_tree
from ..parallel.sharding import ParamSpec

f32 = torch.float32

__all__ = [
    "OptConfig",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "decay_mask",
    "global_norm",
    "opt_state_specs",
]


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim f32 tensor on ``like``'s device: a divisor that ATen
    divides by exactly (a Python scalar divisor of a CUDA tensor becomes a
    multiply by its reciprocal)."""
    return torch.tensor(value, dtype=f32, device=like.device)


def cosine_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up then cosine decay to 0, in f32 (0-dim tensor)."""
    step = step.to(f32)
    warm = torch.minimum(step / _f32(max(cfg.warmup_steps, 1), step),
                         _f32(1.0, step))
    t = torch.clamp(
        (step - cfg.warmup_steps)
        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step),
        0.0, 1.0,
    )
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``sqrt(Σ_leaves Σ l²)`` in f32, leaf by leaf."""
    return torch.sqrt(sum(torch.sum(l.to(f32) ** 2) for l in tree.values()))


def decay_mask(names, specs) -> dict[str, bool]:
    """``{name: decayed}`` for the port's parameter names (``embed.<leaf>``,
    ``layers.<i>.<leaf>``, or the stacked tree's ``layers.<leaf>``): a leaf
    is decayed where its spec in the reference's tree ``specs`` (``layers``
    stacked (L, ...)) has more than one dim — the reference's
    ``p.ndim > 1`` on its stacked tree."""
    ranks = {path: len(s.shape) for path, s in flatten_tree(specs)}
    out = {}
    for name in names:
        path = ".".join(p for p in name.split(".") if not p.isdigit())
        out[name] = ranks[path] > 1
    return out


def adamw_init(params: Mapping[str, torch.Tensor]) -> dict:
    return {
        "m": {k: torch.zeros(p.shape, dtype=f32, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=f32, device=p.device)
              for k, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32,
                             device=next(iter(params.values())).device),
    }


def opt_state_specs(param_specs):
    """The state's spec tree: f32 moments shaped (and axed) as the
    parameters, and an int32 count."""
    def as_f32(tree):
        if isinstance(tree, ParamSpec):
            return ParamSpec(tree.shape, f32, tree.axes)
        return {k: as_f32(v) for k, v in tree.items()}

    return {
        "m": as_f32(param_specs),
        "v": as_f32(param_specs),
        "count": ParamSpec((), torch.int32, ()),
    }


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads: Mapping[str, torch.Tensor],
                 opt_state: dict, params: Mapping[str, torch.Tensor],
                 decay: Mapping[str, bool]):
    """One AdamW step.  Returns ``(params, new_opt_state, metrics)``:
    ``params`` and the moments are the tensors passed in, updated in place;
    ``count`` is a new tensor; ``metrics`` holds ``grad_norm`` (before the
    clip) and ``lr``.  ``decay`` names the decayed leaves
    (:func:`decay_mask`: the tensors' own rank would not do, see the
    module docstring)."""
    count = opt_state["count"] + 1
    lr = cosine_schedule(cfg, count)
    gnorm = global_norm(grads)
    scale = torch.clamp(_f32(cfg.clip_norm, gnorm) / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    countf = count.to(f32)
    bc1 = 1 - torch.pow(_f32(b1, countf), countf)
    bc2 = 1 - torch.pow(_f32(b2, countf), countf)
    for k, p in params.items():
        g = grads[k].to(f32) * scale
        m, v = opt_state["m"][k], opt_state["v"][k]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if decay[k]:
            step = step + cfg.weight_decay * p.to(f32)
        p.copy_((p.to(f32) - lr * step).to(p.dtype))
    new_state = {"m": opt_state["m"], "v": opt_state["v"], "count": count}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
