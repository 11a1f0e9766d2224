"""Device operations the port enqueued (``device_ops.*`` of
``repro_torch.obs.totals()``: fills, copies in, wrap bands, kernels and
trims that copy) over the warm calls' time steps, counted where they are
enqueued: the program's own twin of ``launches_per_step``.  Warm calls
only: the window's and at most 97 outside it
(``bench/program_totals.py``)."""

from bench.program_totals import warm_totals

OPS = ("fill", "copy_in", "wrap", "kernel", "trim")


def read(rec):
    warm = warm_totals()
    if warm is None:
        return None
    ops = sum(warm[f"device_ops.{op}"] for op in OPS)
    return ops / (warm["stencil_call.n"] * rec["steps_per_call"])
