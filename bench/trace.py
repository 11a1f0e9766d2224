"""The traced run's device activity, read from ``torch.profiler``.

Only CUDA activity is recorded (no host-side op events), from just before
the window opens to just after it closes: every device operation recorded
belongs to the window's requests, since set-up ends in a
``synchronize()``.  The benchmark's own host spans (each port call, each
``synchronize()``, the loop's bookkeeping between them) label the device's
idle gaps; they are taken on ``time.perf_counter_ns`` and shifted to the
profiler's clock (Unix ns) by :func:`clock_offset_ns`.
"""

from __future__ import annotations

import time
from collections import defaultdict

def start(on_card: bool):
    """A started profiler of the card's activity, or ``None`` off the card."""
    if not on_card:
        return None
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def stop(prof) -> list | None:
    """Stop ``prof`` and return its device operations as ``(name,
    start_ns, end_ns)``."""
    if prof is None:
        return None
    import torch

    torch.cuda.synchronize()
    prof.stop()
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            s = int(e.start_ns())
            out.append((e.name(), s, s + int(e.duration_ns())))
    return out


def clock_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, the tightest of a few
    bracketed readings."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        t = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, t - (a + b) // 2)
    return best[1]


def short_name(name: str) -> str:
    """A kernel's name without ``void`` and its argument list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:120]


def _union(intervals):
    """The sorted, merged union of ``(start, end)`` intervals."""
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def _minus(intervals, holes):
    """The parts of the sorted, disjoint ``intervals`` outside ``holes``."""
    out = []
    for a, b in intervals:
        for h0, h1 in sorted(holes):
            if h1 <= a or h0 >= b:
                continue
            if h0 > a:
                out.append((a, h0))
            a = max(a, h1)
        if b > a:
            out.append((a, b))
    return out


COPY_SLACK_NS = 1_000_000  # the two clocks' misalignment, and more


def _check_copy(event, holes) -> bool:
    """Whether ``event`` is a copy to the host in one of the ``holes``
    (give or take :data:`COPY_SLACK_NS`): the check's, not the port's.
    The port's own operations are kept even where a hole's edge, on a
    clock a few microseconds off, overlaps them."""
    name, start, end = event
    if "Memcpy" not in name or "DtoH" not in name:
        return False
    return any(a - COPY_SLACK_NS <= start and end <= b + COPY_SLACK_NS
               for a, b in holes)


def summarize(events, open_ns: int, close_ns: int, host,
              holes=()) -> dict | None:
    """Busy seconds (the union of the device operations' intervals), their
    count, seconds by operation name, and the window's idle time split by
    what the host was doing: ``host`` holds the disjoint ``(start, end,
    label)`` spans of the port calls and the ``synchronize()`` calls on
    the profiler's clock, in order; idle time outside them is the loop's
    own bookkeeping (``harness``).  ``holes`` are the ``(start, end)``
    spans in which the window's clock was paused (the check's copies to
    the host): the copies to the host inside one and idle time over one
    are left out.  ``aligned`` says whether 99% of the device time fell inside
    the window on that clock; if not, the idle time is left unlabelled."""
    if events is None:
        return None
    holes = sorted(holes)
    events = [ev for ev in events if not _check_copy(ev, holes)]
    busy_iv = _union((s, e) for _, s, e in events)
    busy = sum(b - a for a, b in busy_iv)
    ops: dict = defaultdict(float)
    for name, s, e in events:
        ops[short_name(name)] += (e - s) / 1e9
    inside = sum(
        max(0, min(b, close_ns) - max(a, open_ns)) for a, b in busy_iv
    )
    aligned = busy > 0 and inside >= 0.99 * busy
    gaps = []
    t = open_ns
    for a, b in busy_iv:
        if a > t:
            gaps.append((t, min(a, close_ns)))
        t = max(t, b)
    if t < close_ns:
        gaps.append((t, close_ns))
    gaps = _minus([(a, b) for a, b in gaps if b > a], holes)
    idle = defaultdict(float)
    longest = []
    if aligned:
        j = 0
        for a, b in gaps:
            split = defaultdict(int)
            while j < len(host) and host[j][1] <= a:
                j += 1
            k = j
            while k < len(host) and host[k][0] < b:
                lo, hi, lab = host[k]
                split[lab] += max(0, min(hi, b) - max(lo, a))
                k += 1
            split["harness"] += (b - a) - sum(split.values())
            for lab, ns in split.items():
                idle[lab] += ns / 1e9
            longest.append(((b - a) / 1e9, max(split, key=split.get)))
    else:
        idle["unlabelled"] = sum(b - a for a, b in gaps) / 1e9
    longest.sort(reverse=True)
    return {
        "busy_s": busy / 1e9,
        "n_ops": len(events),
        "ops": dict(ops),
        "idle": dict(idle),
        "longest_gaps": longest[:10],
        "aligned": aligned,
    }


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the 10 device operations that took
    most time, and the idle time by host state (``all.<label>``) with the
    longest single gaps (``gap.<label>``), at most 10 entries each."""
    top = sorted(summary["ops"].items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(summary["idle"].items(), key=lambda kv: -kv[1])
    gaps = [[f"all.{lab}", s] for lab, s in idle]
    gaps += [[f"gap.{lab}", s] for s, lab in summary["longest_gaps"]]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": gaps[:10]}
