"""Dimension padding: a copy of ``tpu_pad_dim`` from the JAX package's
``core/padding``, which ``ModelCfg.vocab_padded`` rounds the vocabulary
with.  The name is the reference's; the port pads to the same multiple of
128, so the embedding table and the logits have the reference's shape."""

from __future__ import annotations

__all__ = ["tpu_pad_dim"]


def tpu_pad_dim(n: int, unit: int) -> int:
    """Round ``n`` up to a multiple of ``unit``."""
    return -(-n // unit) * unit
