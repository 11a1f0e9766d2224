"""Shares of the port's apply launches by the row path their launcher set
up, from the warm totals (``bench/program_totals.py``).

``repro_torch.obs.totals()`` counts, for each ``sweep_apply`` launch on
the card, ``apply_rows.copy16`` where every window row took the flat
16-byte copy and ``apply_rows.span`` where those rows were also widened
to copy the blocks around their end pieces (``sweep._row_pad``), as
``csrc/sweep_apply.cu``'s launcher returned it.  A port without those
counters, or a run with no apply launch on the card (the CPU's plain
path launches none), reads ``None``.
"""

from __future__ import annotations

from bench.program_totals import warm_totals


def share(counter: str) -> float | None:
    """Warm ``apply_rows.<counter>`` over warm ``launches.sweep_apply``,
    in %."""
    warm = warm_totals()
    if warm is None:
        return None
    got = warm.get(f"apply_rows.{counter}")
    launches = warm.get("launches.sweep_apply")
    if got is None or not launches:
        return None
    return 100.0 * got / launches
