"""Mean host time of one port call, entry to return, on the benchmark's own
clock around the call (the frontend, the IR lowering, the plan memo, the
launch buffers' enqueue, the launch tables and the ctypes launch)."""


def read(rec):
    calls = rec["calls"]
    return sum(b - a for a, b in calls) / len(calls) / 1e6
