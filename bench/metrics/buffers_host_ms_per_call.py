"""Mean self time a warm call of the port's ``launch_buffers`` and
``trim`` stages, in ms: each launch's static geometry and the host's
enqueue of its fill, copy-in and wrap bands (``embed_inputs``), and the
slice back to the grid (``repro_torch.obs.totals()``).  Host time: the
copies themselves run on the card.  Warm calls only: the window's and at
most 97 outside it (``bench/program_totals.py``)."""

from bench.program_totals import ms_per_call


def read(rec):
    return ms_per_call("launch_buffers.self_ns", "trim.self_ns")
