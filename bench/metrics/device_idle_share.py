"""1 - the device's busy time (the union of its operations' intervals)
over the traced window's wall time, in %."""


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / rec["window_s"])
