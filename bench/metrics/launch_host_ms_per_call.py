"""Mean self time a warm call of the port's ``sweep_launch`` stage, in ms:
the ``sweep_apply`` / ``sweep_chain`` wrappers' checks, launch-table key
and lookup, output allocation and ctypes launch (``repro_torch.obs.
totals()``).  Warm calls only: the window's and at most 97 outside it
(``bench/program_totals.py``)."""

from bench.program_totals import ms_per_call


def read(rec):
    return ms_per_call("sweep_launch.self_ns")
