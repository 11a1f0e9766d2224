"""Warm port calls served by the port's call memo (counter
``call_memo.hit``: the call went from its entry straight to its bound
launches) over warm calls (``stencil_call.n``), in %, from
``repro_torch.obs.totals()`` (``bench/program_totals.py``).  A port
without the counter, or a run without a warm call, reads ``None``."""

from bench.program_totals import warm_totals


def read(rec):
    warm = warm_totals()
    if warm is None or warm.get("call_memo.hit") is None:
        return None
    return 100.0 * warm["call_memo.hit"] / warm["stencil_call.n"]
