#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, with no ``PYTHONPATH``.  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device`` (and, traced,
``breakdown``), then ``checks``, each compared number beside its limit;
those numbers are also the last lines of standard error.  Without a CUDA
card, or with fewer cards than the cell asks for, it prints no result and
exits with 3; with JAX or the JAX package loaded once the window has
closed, with 4.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "bench" / ".cache"


def _environment() -> None:
    """Fixed cache directories inside the checkout, few host threads, and
    no trace file of the program's own."""
    os.environ["REPRO_TORCH_PLAN_CACHE_DIR"] = str(CACHE / "plans")
    os.environ["REPRO_TORCH_TUNED_DB_DIR"] = str(CACHE / "tuned")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
    os.environ.pop("REPRO_TORCH_TRACE", None)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def _power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return "not measured"
    return out.stdout.strip() or "not measured"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from bench import harness

    cell = harness.load_cell(args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or (
        torch.cuda.device_count() < cell["chips"]
    ):
        print(
            f"bench: {args.workload} needs {cell['chips']} CUDA card(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count()={torch.cuda.device_count()}",
            file=sys.stderr,
        )
        return 3
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    found = harness.forbidden_modules()  # the window has closed
    if found:
        print("bench: modules of JAX or of the JAX package are loaded: "
              + ", ".join(found), file=sys.stderr)
        return 4
    result["device"]["power_limit"] = _power_limit()
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
