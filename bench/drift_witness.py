#!/usr/bin/env python3
"""What a weight rule does to a long time loop under zero fill, on the card.

    python3 bench/drift_witness.py --workload star13-blocks-128 \\
        --seeds 1 2 3 --steps 6000 --every 250 [--rules per_tap zero_drift]

For each seed and weight rule, one block of the cell's shape is stepped
``--steps`` times by the port's own call (the cell's entry) and, beside
it, by the plain reference computed in float32.  Every ``--every`` steps
it prints, for both chains: the field's largest magnitude, and the
relative difference of one more step against the float64 reference worked
out from the same input (the check's ``max_rel_err``).  Where a field
nears float32's smallest normal number, both chains lose their digits
alike: the cause is then the arithmetic's range, not the port.
"""

import argparse
import json
import sys

from run import _environment  # noqa: E402  (bench/ is this script's path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--every", type=int, default=250)
    ap.add_argument("--rules", nargs="+", default=["per_tap", "zero_drift"])
    args = ap.parse_args(argv)
    _environment()

    import numpy as np
    import torch

    from bench import harness
    from bench.reference import stencil as reference

    if not torch.cuda.is_available():
        print("drift_witness: needs a CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    base = harness.load_cell(args.workload)
    mix = dict(base["mix"], blocks=1, calls_per_request=1, time_steps=1)
    tiny = float(torch.finfo(torch.float32).tiny)

    def err(u, out, taps, weights):
        ref = reference.apply(u, taps, weights, 1, torch.float64,
                              torch.float64)
        scale = float(ref.abs().max())
        e = float((out.double() - ref).abs().max()) / (scale or 1.0)
        return e, scale

    for seed in args.seeds:
        for rule in args.rules:
            config = dict(base["config"], weight_rule=rule)
            cell = dict(base, config=config, mix=mix)
            taps, weights, (u,) = harness.inputs(config, mix, seed, dev)
            moment = (np.array(taps).T @ np.array(weights)).tolist()
            call = harness.port_entry(cell, taps, weights, dev)
            x = u.clone()
            for step in range(args.steps + 1):
                if step % args.every == 0:
                    out_p, out_r = call(u), reference.apply(
                        x, taps, weights, 1, torch.float32)
                    e_p, s_p = err(u, out_p, taps, weights)
                    e_r, s_r = err(x, out_r, taps, weights)
                    print(json.dumps({
                        "seed": seed, "rule": rule, "step": step,
                        "first_moment": moment,
                        "port_max_abs": float(u.abs().max()),
                        "port_rel_err": e_p, "port_ref_scale": s_p,
                        "f32_ref_max_abs": float(x.abs().max()),
                        "f32_ref_rel_err": e_r, "f32_ref_scale": s_r,
                        "f32_tiny": tiny,
                    }), flush=True)
                    u, x = out_p, out_r
                else:
                    u = call(u)
                    x = reference.apply(x, taps, weights, 1, torch.float32)
            torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
