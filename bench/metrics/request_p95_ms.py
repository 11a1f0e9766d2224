"""The 95th percentile (nearest rank) of every request's latency: the host
clock from the request's first call to its ``synchronize()`` returning."""

import math


def read(rec):
    lat = sorted(end - start for start, _, end in rec["requests"])
    return lat[math.ceil(0.95 * len(lat)) - 1] / 1e6
