#!/usr/bin/env python3
"""Run the transformer phases of ``chip_smoke.py`` alone.

    python3 scripts/lm_phases.py [granite_serve] [granite_train] [families]
                                 [ARCH ...] [--out FILE]

Run from the root of a checkout on a machine with an NVIDIA H100 (no
``PYTHONPATH`` needed).  With no phase named, all three run:
``granite_serve`` (granite-3-2b at full size, batch 4 × 2048 + 16),
``granite_train`` (batch 2 × 4096) and ``families_serve`` (each other
architecture of ``chip_smoke.FAMILIES`` at published width, its depth
cut by ``chip_smoke.fit_layers``); an architecture's name runs that
family alone.  The phases are ``chip_smoke.lm_serve_phase`` and
``lm_train_phase`` with the smoke's checks, weights from seed 0 and the
precision pinned (``runtime.isa.pin_precision``: TF32 off); none of the
port's kernels is on these paths, so nothing is built.
A family that fails is reported and the rest still run; the exit code is
1 if any failed.  Each phase's record is printed (cut to 3,000
characters) and appended whole to ``--out`` (JSON lines), followed by
its seconds; the card's name and power limit, as ``nvidia-smi`` gives
them, come first.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

PHASES = ("granite_serve", "granite_train", "families")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("phases", nargs="*",
                    help=f"any of {', '.join(PHASES)} or an architecture")
    ap.add_argument("--out", default="", help="JSON-lines file to append to")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.runtime.isa import pin_precision

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    pin_precision()
    dev = torch.device("cuda")
    card_line = cs.card()
    print(card_line, torch.__version__, torch.version.cuda, flush=True)
    kernels = ("sweep_apply", "sweep_chain", "conv1d")
    since: dict = {}
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec, default=str)
        print(line[:3000], flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def reset():
        since.clear()
        since.update(obs.totals())

    def counts():
        now = obs.totals()
        return {n: now[f"launches.{n}"] - since.get(f"launches.{n}", 0)
                for n in kernels}

    def max_err(a, b):
        return float((a.float() - b.float()).abs().max())

    def bits_equal(a, b):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.element_size() == 1:
            return bool(torch.equal(a, b))
        v = torch.int16 if a.element_size() == 2 else torch.int32
        return bool(torch.equal(a.contiguous().view(v),
                                b.contiguous().view(v)))

    want = set(args.phases) or set(PHASES)
    archs = want - set(PHASES)
    failed = []
    t_all = time.perf_counter()

    def timed(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # reported; the exit code says it failed
            traceback.print_exc()
            failed.append(name)
            print("FAILED", name, repr(e)[:500], flush=True)
            torch.cuda.empty_cache()
        emit({"phase": "seconds", "of": name,
              "seconds": time.perf_counter() - t0,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})

    if "granite_serve" in want:
        timed("granite_serve", lambda: cs.lm_serve_phase(
            torch, dev, card_line, emit, reset, counts, max_err,
            "granite-3-2b", 4, 2048, 16, warm=2, profile=True, cpu_layers=2,
            name="granite_serve"))
    if "granite_train" in want:
        timed("granite_train", lambda: cs.lm_train_phase(
            torch, dev, card_line, emit, reset, counts, bits_equal, max_err))
    for arch, b, n, cl, ct in cs.FAMILIES:
        if "families" in want or arch in archs:
            timed(arch, lambda arch=arch, b=b, n=n, cl=cl, ct=ct:
                  cs.lm_serve_phase(
                      torch, dev, card_line, emit, reset, counts, max_err,
                      arch, b, n, 5, layers=cs.fit_layers(get_config(arch)),
                      cpu_layers=cl, cpu_tokens=ct))
    emit({"phase": "seconds", "of": "all",
          "seconds": time.perf_counter() - t_all, "failed": failed})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
