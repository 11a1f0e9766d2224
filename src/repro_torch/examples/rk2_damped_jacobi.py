"""RK2-style damped-Jacobi smoother pair as a fused stage-chain program,
on the port.

The classic two-sweep smoother applies the damped Jacobi operator

    u  <-  (1 - omega) u + (omega / 2d) * sum(neighbors)

twice with *distinct* damping factors (omega_1, omega_2) — the same
shape as an RK2 sub-step pair for du/dt = L u: two linear stages, one
operator footprint, different per-stage weights.  The chain kernel
(``csrc/sweep_chain.cu``) fuses both sweeps into one pass over device
memory: a CTA's shared-memory window carries the two-stage dependency
cone, and the intermediate iterate lives in a streaming frontier ring
that persists across the column's sweep steps, so neither stage is
recomputed inside the window overlap.

Run:  PYTHONPATH=src python -m repro_torch.examples.rk2_damped_jacobi [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..core.cache_fitting import star_stencil
from ..kernels.ref import stencil_ref
from ..kernels.stencil import stencil_iterate
from ..plan import PlanCache, Planner

__all__ = ["damped_jacobi_stage", "main"]

SHAPE = (48, 64, 96)
OMEGAS = (0.8, 0.5)   # distinct per-stage damping: the "RK2" pair


def damped_jacobi_stage(d: int, omega: float):
    """(offsets, weights) of one damped-Jacobi sweep of the 2d-point
    Laplacian: contraction for omega in (0, 1]."""
    offs = star_stencil(d, 1)
    weights = [
        (1.0 - omega) if not any(off) else omega / (2 * d) for off in offs
    ]
    return offs, weights


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs=3, default=SHAPE)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    shape = tuple(args.shape)
    dev = resolve_device(args.device)
    d = len(shape)
    stages = [damped_jacobi_stage(d, w) for w in OMEGAS]
    rng = np.random.default_rng(0)
    u = torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(dev)

    # Plan the chain explicitly to show the planner's reasoning;
    # stencil_iterate would consult the same planner implicitly.  The
    # window is a CTA's shared memory (at most 227 KB), smaller than the
    # grid, so the chain sweeps and the frontier ring streams.
    planner = Planner(cache=PlanCache(persistent=False))
    plan = planner.plan(shape=shape, stages=[offs for offs, _ in stages],
                        aligned=True)
    print(f"grid {shape}, {len(stages)}-stage damped-Jacobi chain "
          f"(omegas {OMEGAS})")
    print(f"  tile {plan.tile}, sweep axis {plan.sweep_axis}, "
          f"fused depth {plan.fused_depth}, window {plan.window_kind}, "
          f"modeled {plan.modeled_ms:.4f} ms")
    print(f"  modeled traffic {plan.traffic_bytes / (1 << 20):.2f} MiB "
          f"(single-pass chain: "
          f"{plan.single_pass_traffic_bytes / (1 << 20):.2f} MiB -> "
          f"{plan.single_pass_traffic_bytes / plan.traffic_bytes:.2f}x cut)")
    print(f"  modeled flops: streaming {plan.modeled_flops:,} vs recompute "
          f"{plan.recompute_flops:,} "
          f"({plan.recompute_flops / max(plan.modeled_flops, 1):.2f}x saved)")

    fused = stencil_iterate(u, stages=stages, plan=plan, device=dev)

    ref = u
    for offs, w in stages:
        ref = stencil_ref(ref, offs, w)
    err = float((fused - ref).abs().max())
    print(f"  max |fused - iterated reference| = {err:.2e}")
    assert err < 1e-5, "fused chain diverged from the iterated reference"
    resid = float(fused.abs().max() / u.abs().max())
    print(f"  smoother contraction (max-norm ratio) = {resid:.3f}")
    print("OK")


if __name__ == "__main__":
    main()
