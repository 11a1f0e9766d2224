"""Mean self time of the port's ``decide`` stage a warm call, in ms: the
launch decision (``_auto_tile``'s signature and the planner's memo, or
``validate_plan_call``) up to the resolved tile (``repro_torch.obs.
totals()``).  Warm calls only: the window's and at most 97 outside it
(``bench/program_totals.py``)."""

from bench.program_totals import ms_per_call


def read(rec):
    return ms_per_call("decide.self_ns")
