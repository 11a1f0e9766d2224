"""Grid points times time steps of every request completed in the window,
over the window's seconds, in billions (Gpt/s)."""


def read(rec):
    calls = len(rec["calls"])
    return calls * rec["points_per_call"] * rec["steps_per_call"] / (
        rec["window_s"] * 1e9)
