"""``torch.cuda.max_memory_allocated()`` over the window, reset when it
opens, in GB (1e9 bytes); nothing off the card."""


def read(rec):
    peak = rec["peak_bytes"]
    return None if peak is None else peak / 1e9
