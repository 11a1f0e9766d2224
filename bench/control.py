#!/usr/bin/env python3
"""The readings a cell's check limit is set from, in one process.

    python3 bench/control.py --workload <cell> --seconds 3 \\
        --seeds 11 12 ... --control-seeds 21 22 23 \\
        [--faults [KIND ...]] [--fault-seconds 51] [--out FILE]

For each of ``--seeds`` a sound run of the port (a short window at the
cell's own size) gives the compared numbers; the largest of each is its
lower reading.  For each of ``--control-seeds`` the control, the plain
reference computed in the configuration's ``check.control_dtype`` in the
port's place, gives them too; the smallest is the upper reading.
``--faults`` adds one run of each broken timed path of
:mod:`bench.faults` (or of those named), each ``--fault-seconds`` long.
``--weight-rule`` and ``--control-dtype`` override the configuration's
(a look at what a rule or a precision does to the check).  Every reading
is printed as a JSON line (and appended to ``--out``), then a summary
line.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time

from run import _environment  # noqa: E402  (bench/ is this script's path)

NUMBERS = ("max_rel_err", "fresh_max_rel_err")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*")
    ap.add_argument("--fault-seconds", type=float)
    ap.add_argument("--weight-rule")
    ap.add_argument("--control-dtype")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    _environment()

    import torch

    from bench import faults, harness

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    if args.weight_rule:
        cell["config"]["weight_rule"] = args.weight_rule
    if args.control_dtype:
        cell["config"]["check"]["control_dtype"] = args.control_dtype
    runs = [("program", s, harness.port_entry, args.seconds)
            for s in args.seeds]
    runs += [("control", s, harness.control_entry, args.seconds)
             for s in args.control_seeds]
    if args.faults is not None:
        seed = (args.seeds or args.control_seeds or [1])[0]
        runs += [(f"fault.{k}", seed, faults.entry(k),
                  args.fault_seconds or args.seconds)
                 for k in (args.faults or faults.KINDS)]
    lines = []
    for kind, seed, entry, seconds in runs:
        t0 = time.perf_counter()
        r = harness.run_cell(cell, seed, seconds, False, entry=entry)
        line = {
            "workload": args.workload, "kind": kind, "seed": seed,
            "seconds": seconds, "weight_rule": cell["config"]["weight_rule"],
            "correct": r["correct"], "attempted": r["attempted"],
            "calls": r["calls"],
            **{k: float(c["value"]) for k, c in r["checks"].items()},
            "scales": r["check_scales"],
            "run_s": time.perf_counter() - t0,
            "device": r["device"]["kind"],
        }
        lines.append(line)
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    summary = {"workload": args.workload, "kind": "summary",
               "limit": cell["config"]["check"]["max_rel_err"]}
    for n in NUMBERS:
        prog = [ln[n] for ln in lines if ln["kind"] == "program"]
        ctrl = [ln[n] for ln in lines if ln["kind"] == "control"]
        summary[n] = {"lower": max(prog, default=None),
                      "upper": min(ctrl, default=None)}
    summary["program_all_correct"] = all(
        ln["correct"] for ln in lines if ln["kind"] == "program")
    summary["control_or_faults_correct"] = [
        ln["kind"] for ln in lines
        if ln["kind"] != "program" and ln["correct"]]
    lines.append(summary)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(ln) + "\n" for ln in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
