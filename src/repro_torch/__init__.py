"""PyTorch/CUDA port of the sweep-engine stencil system.

The JAX package ``repro`` is the reference; this package imports none of
it.  Its entry points run on the card: ``device=None`` means ``"cuda"``,
and a caller that wants the CPU (the tests) passes ``device="cpu"``.
Without CUDA and without ``device="cpu"`` they raise — they never run on
the CPU quietly.  ``device="meta"`` (shapes without storage, the
dry-run's device) is taken only where a caller names it.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``;
    ``"cpu"`` and ``"meta"`` only when named.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device, and torch.cuda.is_available() "
            "is false; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
