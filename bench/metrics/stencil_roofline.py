"""The work's least time (``bench/roofline.py``: grid, taps, time steps
and dtype, at the H100 SXM's published rates) over the device's busy time
in the window (the union of every device operation's interval, from
``torch.profiler``), in %.  Nothing without a trace."""


def read(rec):
    tr = rec["trace"]
    if tr is None or tr["busy_s"] <= 0:
        return None
    least = len(rec["calls"]) * rec["work"]["least_s"]
    return 100.0 * least / tr["busy_s"]
