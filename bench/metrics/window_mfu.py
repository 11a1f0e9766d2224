"""The window's total least time (``bench/roofline.py``, the published H100
SXM rates) over its wall time, in %: the whole loop's share of the
chip's peak, host time included. """


def read(rec):
    least = len(rec["calls"]) * rec["work"]["least_s"]
    return 100.0 * least / rec["window_s"]
