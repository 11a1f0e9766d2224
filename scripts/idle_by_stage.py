#!/usr/bin/env python3
"""The device's idle time in one benchmark cell, split by the port's stage.

    python3 scripts/idle_by_stage.py --workload star13-blocks-128 \
        --seed 2147483659 --seconds 51 [--profiler 1] [--record 1] [--bridge 0]

From the root of a checkout, on an NVIDIA H100, with no ``PYTHONPATH``.
It sets up the cell as ``bench/run.py`` does (``bench.harness``: the
configuration, the mix, the seeded inputs, the mix's entry, the warm-up
requests), then runs the entry in a closed loop for ``--seconds`` under
``torch.profiler`` (CUDA activity, ``bench.trace``) and a
``repro_torch.obs`` recorder, and prints one JSON line:

* ``idle_s``: the window's device-idle seconds by what the host was doing
  at each moment: the innermost port stage open (``frontend``,
  ``decide``, ``launch_buffers``, ``sweep_launch``, ``trim``, or
  ``stencil_call`` for the call's own code between them), or outside a
  call (``outside:synchronize``, the request's wait; ``outside:loop``,
  this loop's bookkeeping).  The recorder's stage spans are put on the
  profiler's clock by its ``t0_unix_ns``;
* ``busy_s``, ``window_s``, ``calls``, ``host_ms_per_call`` (this loop's
  clock around each call, as ``host_ms_per_call`` reads it);
* the recorder's cost: ``spans``, ``rss_peak_mb`` and ``rss_grown_mb``
  (the process's peak resident memory, and its growth over the window),
  ``trace_mb`` and ``write_s`` (the trace file, written under ``build/``
  and deleted).

``--profiler 0`` leaves the profiler out (no ``idle_s``); ``--record 0``
the recorder (the loop's own cost, for the recorder's).  ``--bridge 1``
gives the recorder its profiler bridge (a ``record_function`` range a
span, as ``obs.recording()`` does by default); without it the recorder
costs the calls less, and the split is nearer an untraced call's.  It
edits no file of ``bench/`` and prints no benchmark result line.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "bench" / ".cache"
TRACE_DIR = ROOT / "build" / "idle_by_stage"


def _environment() -> None:
    """The benchmark's cache directories and thread counts, and the
    checkout's packages on ``sys.path``."""
    os.environ["REPRO_TORCH_PLAN_CACHE_DIR"] = str(CACHE / "plans")
    os.environ["REPRO_TORCH_TUNED_DB_DIR"] = str(CACHE / "tuned")
    os.environ.pop("REPRO_TORCH_TRACE", None)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def innermost(spans):
    """Disjoint ``(start, end, label)`` segments of properly nested
    ``(start, end, label)`` spans, each labelled by the innermost span
    open over it."""
    out = []
    stack: list = []  # (end, label), innermost last
    t = None
    for s, e, lab in sorted(spans, key=lambda v: (v[0], -v[1])):
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            if t < end:
                out.append((t, end, top))
            t = max(t, end)
        if stack and t < s:
            out.append((t, s, stack[-1][1]))
        stack.append((e, lab))
        t = s
    while stack:
        end, top = stack.pop()
        if t < end:
            out.append((t, end, top))
        t = max(t, end)
    return out


def _rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--profiler", type=int, choices=(0, 1), default=1)
    ap.add_argument("--record", type=int, choices=(0, 1), default=1)
    ap.add_argument("--bridge", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from bench import harness, trace
    from repro_torch import obs

    if not torch.cuda.is_available():
        print("idle_by_stage.py: needs a CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    dev = torch.device("cuda")
    cell = harness.load_cell(args.workload)
    taps, weights, blocks = harness.inputs(cell["config"], cell["mix"],
                                           args.seed, dev)
    call = harness.port_entry(cell, taps, weights, dev)
    order = [i % len(blocks)
             for i in range(int(cell["mix"]["calls_per_request"]))]

    calls: list = []
    syncs: list = []

    def request(keep: bool) -> None:
        for b in order:
            c0 = time.perf_counter_ns()
            blocks[b] = call(blocks[b])
            c1 = time.perf_counter_ns()
            if keep:
                calls.append((c0, c1))
        s0 = time.perf_counter_ns()
        torch.cuda.synchronize(dev)
        if keep:
            syncs.append((s0, time.perf_counter_ns()))

    for _ in range(harness.WARM_REQUESTS):
        request(False)
    rss0 = _rss_mb()
    prof = trace.start(True) if args.profiler else None
    rec = None
    scope = (obs.recording(profiler_bridge=bool(args.bridge))
             if args.record else None)
    if scope is not None:
        rec = scope.__enter__()
    limit = int(args.seconds * 1e9)
    t_open = time.perf_counter_ns()
    try:
        while time.perf_counter_ns() - t_open < limit:
            request(True)
    finally:
        if scope is not None:
            scope.__exit__(None, None, None)
    t_close = syncs[-1][1]
    events = trace.stop(prof) if prof is not None else None

    out = {
        "workload": args.workload,
        "card": torch.cuda.get_device_name(dev),
        "profiler": bool(args.profiler),
        "record": bool(args.record),
        "bridge": bool(args.record and args.bridge),
        "window_s": (t_close - t_open) / 1e9,
        "calls": len(calls),
        "host_ms_per_call": sum(b - a for a, b in calls) / len(calls) / 1e6,
        "rss_peak_mb": _rss_mb(),
        "rss_grown_mb": _rss_mb() - rss0,
    }
    if rec is not None:
        out["spans"] = len(rec.spans)
        TRACE_DIR.mkdir(parents=True, exist_ok=True)
        path = TRACE_DIR / f"{args.workload}.json"
        w0 = time.perf_counter()
        rec.write(str(path))
        out["write_s"] = time.perf_counter() - w0
        out["trace_mb"] = path.stat().st_size / 1e6
        path.unlink()
    if events is not None:
        offset = trace.clock_offset_ns()
        host = [(a + offset, b + offset, "outside:synchronize")
                for a, b in syncs]
        if rec is not None:
            # The stage spans' perf_counter ns on the profiler's clock.
            shift = rec.t0_unix_ns - round(rec.t0_us * 1e3)
            stages = [
                (round(sp.ts_us * 1e3) + shift,
                 round((sp.ts_us + sp.dur_us) * 1e3) + shift, sp.name)
                for sp in rec.spans if sp.cat == "repro_torch.stage"
            ]
            host += innermost(stages)
        else:
            host += [(a + offset, b + offset, "stencil_call")
                     for a, b in calls]
        host.sort()
        summ = trace.summarize(events, t_open + offset, t_close + offset,
                               host)
        idle = dict(summ["idle"])
        if "harness" in idle:
            idle["outside:loop"] = idle.pop("harness")
        out.update(busy_s=summ["busy_s"], n_ops=summ["n_ops"],
                   aligned=summ["aligned"],
                   idle_s=dict(sorted(idle.items(), key=lambda kv: -kv[1])))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
