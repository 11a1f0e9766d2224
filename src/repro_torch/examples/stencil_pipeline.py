"""The paper's application on the port: Jacobi-style sweeps of the
13-point operator over a 3-D structured grid, with the card's tile plan
and layout advice.

    PYTHONPATH=src python -m repro_torch.examples.stencil_pipeline --iters 10
    PYTHONPATH=src python -m repro_torch.examples.stencil_pipeline --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..core.padding import advise_dim, tpu_layout_waste
from ..kernels.ops import apply_star_2nd_order, plan_tiles
from ..kernels.ref import star_weights_2nd_order, stencil_ref

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs=3, default=(32, 64, 256))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    shape = tuple(args.shape)
    dev = resolve_device(args.device)

    # Layout advice on the card: is the minor dim a whole number of
    # 128-byte lines, and what share of the launch buffer is slack?
    adv = advise_dim(shape[-1], dtype_bytes=4)
    print(f"minor dim {shape[-1]}: "
          f"{'pad to ' + str(adv['padded']) if adv['unfavorable'] else 'favorable'}")
    plan = plan_tiles(shape, r=2)
    waste = tpu_layout_waste(shape, plan.tile, halo=2)
    print(f"tile plan: {plan.tile} grid={plan.grid} sweep axis "
          f"{plan.sweep_axis} traffic={plan.traffic_bytes/1e6:.1f}MB "
          f"efficiency={plan.efficiency:.2f} modeled={plan.modeled_ms:.4f}ms "
          f"launch-buffer waste={waste:.3f}")

    rng = np.random.default_rng(0)
    u = torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(dev)
    # One verification sweep against the oracle (keep the planner's sweep
    # axis: the tile shape was chosen for it).
    out = apply_star_2nd_order(u, tile=plan.tile, sweep_axis=plan.sweep_axis,
                               device=dev)
    ref = stencil_ref(u, *star_weights_2nd_order(3, 2))
    err = float((out - ref).abs().max())
    assert err < 1e-3, err
    print(f"verified vs oracle (max|err|={err:.2e}); running {args.iters} sweeps")

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    x = u
    for _ in range(args.iters):
        x = apply_star_2nd_order(x, tile=plan.tile, sweep_axis=plan.sweep_axis,
                                 device=dev)
        x = x / torch.clamp(x.abs().max(), min=1e-6)  # keep finite
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    pts = np.prod(shape) * args.iters
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "CPU, the kernel's plain version")
    print(f"{dt:.2f}s total, {pts/dt/1e6:.1f} Mpoint/s ({where})")
    return x


if __name__ == "__main__":
    main()
