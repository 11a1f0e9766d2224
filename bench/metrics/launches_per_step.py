"""Device operations (kernels, copies, fills) in the traced window, over
the time steps done: an exact count."""


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    return tr["n_ops"] / (len(rec["calls"]) * rec["steps_per_call"])
