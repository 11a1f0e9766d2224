"""The port's own stage totals, as the per-layer readers of
``bench/metrics/`` take them.

``repro_torch.obs.totals()`` keeps, in the benchmark's own process and
whether or not a recorder is installed, each stage's time and each
counter over the port's **warm** calls (calls in which no cache on the
path missed).  Those are the window's calls and a few outside it: the
warm-up requests' calls after the first cold one and the calls on fresh
grids after the window (at most 4 against 6,500–34,000 at 512³, and 97
against about 144,000 in the blocks cell: under 0.1%).  A port without
the totals, or a run without a warm call, reads ``None``.
"""

from __future__ import annotations


def warm_totals() -> dict | None:
    """``repro_torch.obs.totals()["warm"]``, or ``None`` where the port
    keeps no totals or no warm call was made."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    totals = getattr(obs, "totals", None)
    if totals is None:
        return None
    warm = totals().get("warm")
    if not warm or not warm.get("stencil_call.n"):
        return None
    return warm


def ms_per_call(*keys: str) -> float | None:
    """The sum of the warm totals' ``keys`` (nanoseconds) over the warm
    calls, in ms."""
    warm = warm_totals()
    if warm is None:
        return None
    return sum(warm[k] for k in keys) / warm["stencil_call.n"] / 1e6
