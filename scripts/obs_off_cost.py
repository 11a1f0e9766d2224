#!/usr/bin/env python3
"""Time the stencil calls that telemetry instruments, with recording off.

Run on an NVIDIA H100:

    python3 scripts/obs_off_cost.py [--src DIR] [--label NAME] [--reps 20]

``--src`` is the ``src/`` directory of the checkout to time (default this
one's), so that two checkouts — one without the telemetry hooks, one with
them — can be timed in turns in one chip call (parent, change, change,
parent), each in a process of its own.  On ``chip_smoke.py``'s two
shapes (``apply_f32_512``: the 13-point star once on a 512³ f32 grid at
tile (8, 16, 32); ``chain_T3_512``: the star three times, fused, at tile
(4, 16, 32)) it prints one JSON line with the card, and for each shape
the median over ``--rounds`` rounds of: ``ms``, one kernel wrapper call
between CUDA events (the smoke's ``ms``; the wrapper is the call's
``sweep_launch`` stage), and ``call_ms``, one frontend call
(``stencil_pallas`` / ``stencil_iterate`` with the tile), which runs the
hooks' predicate checks once a launch and the always-on stage timers.
Each round's figure is the median of ``--reps`` calls after 2 warm-up
calls.  ``stage_timers_us`` is the host cost of the always-on stage
timers of one call as the benchmark's blocks cell makes it (the root
stage, five stages, five counter bumps; ``repro_torch.obs.stages``),
timed alone over 20,000 calls a round, the median of ``--rounds``
rounds (``null`` for a checkout without them).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def stage_timers_us(rounds: int, n: int = 20_000):
    """Median over ``rounds`` of the stage timers' host µs a call."""
    import time

    from repro_torch import obs

    if not hasattr(obs, "call"):
        return None
    stages = [obs.stage(s) for s in ("frontend", "decide", "launch_buffers",
                                     "sweep_launch", "trim")]
    counts = [obs.counter(c) for c in (
        "plan_memo_hit", "device_ops.fill", "device_ops.copy_in",
        "launch_table_hit", "device_ops.kernel")]

    def one():
        with obs.call():
            for s in stages:
                s.begin()
                s.end()
            for c in counts:
                obs.count(c)

    for _ in range(1000):
        one()
    per = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(n):
            one()
        per.append((time.perf_counter() - t0) / n * 1e6)
    return statistics.median(per)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    from repro_torch.kernels import ref, sweep
    from repro_torch.kernels import stencil as st

    if not torch.cuda.is_available():
        print("obs_off_cost.py: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")

    def time_ms(fn) -> float:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    out = {"label": args.label, "src": args.src, "card": card,
           "stage_timers_us": stage_timers_us(args.rounds)}

    def spec(o, w):
        return (tuple(map(tuple, o.tolist())), tuple(float(v) for v in w))

    offs13, w13 = ref.star_weights_2nd_order(3, 2)
    gen = torch.Generator(device=dev)

    gen.manual_seed(0)
    u = torch.randn((512,) * 3, generator=gen, device=dev)
    tile = (8, 16, 32)
    ins, offs, wts, _, lo_w, hi_w = st._launch_inputs(
        [u], (spec(offs13, w13),), tile)
    args_ = (ins, offs, wts, lo_w, hi_w, tile, 0, True)
    rounds = [(time_ms(lambda: sweep.sweep_apply(*args_)),
               time_ms(lambda: st.stencil_pallas(u, offs13, w13, tile=tile,
                                                 sweep_axis=0)))
              for _ in range(args.rounds)]
    out["apply_f32_512"] = {
        "ms": statistics.median(r[0] for r in rounds),
        "call_ms": statistics.median(r[1] for r in rounds),
        "rounds": rounds,
    }
    del ins, args_

    gen.manual_seed(2)
    u = torch.randn((512,) * 3, generator=gen, device=dev)
    tile = (4, 16, 32)
    sw = (spec(offs13, w13),) * 3
    ins, _, _, stages, lo_w, hi_w = st._launch_inputs([u], sw[:1], tile, sw)
    cargs = (ins[0], stages, lo_w, hi_w, tile, 0, True, "ring", (512,) * 3)
    rounds = [(time_ms(lambda: sweep.sweep_chain(*cargs)),
               time_ms(lambda: st.stencil_iterate(u, offs13, w13, 3,
                                                  tile=tile, sweep_axis=0)))
              for _ in range(args.rounds)]
    out["chain_T3_512"] = {
        "ms": statistics.median(r[0] for r in rounds),
        "call_ms": statistics.median(r[1] for r in rounds),
        "rounds": rounds,
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
