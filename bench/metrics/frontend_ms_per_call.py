"""Mean self time of the port's ``frontend`` stage a warm call, in ms:
``_as_tensors``, dtype resolution, the program's build, ``ir.lower`` and
the static specs (``repro_torch.obs.totals()``).  Warm calls only: the
window's and at most 97 outside it (``bench/program_totals.py``)."""

from bench.program_totals import ms_per_call


def read(rec):
    return ms_per_call("frontend.self_ns")
