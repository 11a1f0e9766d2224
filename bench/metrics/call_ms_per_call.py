"""Mean host time of one warm port call, entry to return, timed inside the
port: its root stage ``stencil_call`` (``repro_torch.obs.totals()``), the
inside twin of ``host_ms_per_call``.  Warm calls only: the window's and at
most 97 outside it (``bench/program_totals.py``)."""

from bench.program_totals import ms_per_call


def read(rec):
    return ms_per_call("stencil_call.ns")
