"""Int8 gradient compression with error feedback (DESIGN.md §6).

The JAX package's ``optim/compression.py``: each worker quantizes its
local gradient to int8 with a per-tensor scale, the int8 payloads are
summed (8× less wire traffic than f32), the sum is dequantized with the
mean of the scales, and each worker carries its quantization residual
into the next step (error feedback; Karimireddy et al. 2019).

The reference ``psum``s over mesh axes inside ``shard_map``.  Here, as in
``parallel/shard_columns.py``, one process drives a list of workers: the
caller passes one gradient mapping per worker (each on its worker's
device) and gets back each worker's mean and residual.  The int32 code
sum is exact in any order; the scales are summed in worker order.

:func:`_quantize` divides exactly: the scale is the IEEE quotient
``max|g| / 127`` and a code ``round`` half-even of the IEEE quotient
``g / scale``.  On the CPU, the reference's jitted code computes both as
reciprocal products (``max|g| · (1/127)``, ``g · (1/scale)``), so a scale
can differ by an ulp and a code by one (``ROADMAP.md`` queue C).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence

import torch

f32 = torch.float32

__all__ = ["CompressionState", "compressed_mean"]


@dataclass
class CompressionState:
    residual: Any  # one mapping like the gradients per worker


def _quantize(g: torch.Tensor):
    """``(q int8, scale f32 0-dim)``: ``scale = max(max|g|, 1e-12) / 127``
    and ``q = clip(round(g / scale), -127, 127)``."""
    d127 = torch.tensor(127.0, dtype=f32, device=g.device)
    scale = torch.clamp(g.abs().max(), min=1e-12) / d127
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_mean(grads: Sequence[Mapping[str, torch.Tensor]],
                    residual: Optional[Sequence[Mapping]] = None):
    """Quantize each worker's gradients, sum the codes and the scales over
    the workers, and dequantize: ``mean = Σq · (Σscale / n) / n``.

    ``grads`` holds one ``{name: tensor}`` per worker.  Returns
    ``(means, residuals)``, one mapping per worker: the mean (the same
    values on every worker, on its device) and ``g - q · scale``.  With
    ``residual=None``, compression without error feedback."""
    n_workers = len(grads)
    if residual is None:
        residual = [None] * n_workers
    means = [{} for _ in range(n_workers)]
    new_r = [{} for _ in range(n_workers)]
    for k in grads[0]:
        gs, qs, scales = [], [], []
        for w in range(n_workers):
            g = grads[w][k].to(f32)
            if residual[w] is not None:
                g = g + residual[w][k]
            q, scale = _quantize(g)
            gs.append(g)
            qs.append(q)
            scales.append(scale)
        home = gs[0].device
        total = qs[0].to(torch.int32)
        scale_sum = scales[0]
        for q, scale in zip(qs[1:], scales[1:]):
            total = total + q.to(home, torch.int32)
            scale_sum = scale_sum + scale.to(home)
        n = torch.tensor(float(n_workers), dtype=f32, device=home)
        mean = total.to(f32) * (scale_sum / n) / n
        for w in range(n_workers):
            means[w][k] = mean.to(gs[w].device)
            new_r[w][k] = gs[w] - qs[w].to(f32) * scales[w]
    return means, new_r
