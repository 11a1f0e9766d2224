"""Quickstart: the paper's machinery end to end on one grid, on the port.

    PYTHONPATH=src python -m repro_torch.examples.quickstart            # the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The paper's numbers on its unfavorable (45, 91, 60) grid under its
(2, 512, 4) cache — shortest lattice vector, padding advice, natural
against cache-fitting misses, the load bounds — are CPU arithmetic on the
port's ``core/`` (:func:`paper_numbers`).  Then the Hopper side: the tile
the cost model picks for (64, 128, 512) (where the JAX twin shows a TPU
VMEM tile), the planned kernel against the ``stencil_ref`` oracle, the
plan compiler's report for the paper's grid and the kernel run from a
plan.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..core.cache_fitting import (
    access_stream,
    natural_order,
    plan_schedule,
    star_stencil,
    upper_bound_loads,
)
from ..core.cache_sim import simulate_misses
from ..core.isoperimetric import lower_bound_loads
from ..core.lattice import CacheGeometry, InterferenceLattice
from ..core.padding import is_unfavorable, pad_grid
from ..kernels.ops import apply_star_2nd_order, plan_tiles
from ..kernels.ref import star_weights_2nd_order, stencil_ref
from ..kernels.stencil import stencil_pallas
from ..plan import PlanCache, Planner

__all__ = ["main", "paper_numbers"]


def paper_numbers(dims=(45, 91, 60), favorable=(64, 91, 60),
                  geometry=(2, 512, 4)) -> dict:
    """The paper's figures for grid ``dims`` under cache ``geometry``
    ``(a, z, w)``: its shortest lattice vector and §6 verdict (diameter
    5, the 13-point star), the padding advisor's grid, misses a point in
    natural and cache-fitting order on ``dims``, its padded grid and
    ``favorable`` (the simulated cache), and the lower and upper load
    bounds on the padded grid."""
    geom = CacheGeometry(*geometry)
    S = geom.size_words
    dims = tuple(int(n) for n in dims)
    lat = InterferenceLattice(dims, S)
    padded, info = pad_grid(dims, S, diameter=5)
    K = star_stencil(3, 2)
    misses = {}
    for name, d in (("unfavorable", dims), ("padded", padded),
                    ("favorable", tuple(favorable))):
        order, bq, _ = plan_schedule(d, S, 2, geom=geom)
        pts = (d[0] - 4) * (d[1] - 4) * (d[2] - 4)
        nat = simulate_misses(
            access_stream(d, natural_order(d, 2), K, base_q=bq), geom)
        fit = simulate_misses(access_stream(d, order, K, base_q=bq), geom)
        misses[name] = {"dims": d, "points": pts, "natural": int(nat),
                        "cache_fitting": int(fit)}
    return {
        "dims": dims, "S": S,
        "shortest": tuple(int(v) for v in lat.shortest(norm="l1")),
        "unfavorable": bool(is_unfavorable(dims, S, diameter=5)),
        "padded": tuple(padded), "extra_words": int(info["extra_words"]),
        "shortest_before": float(info["shortest_before"]),
        "shortest_after": float(info["shortest_after"]),
        "misses": misses,
        "lower_bound": float(lower_bound_loads(padded, S)["bound"]),
        "upper_bound": float(upper_bound_loads(padded, S, 2)["bound"]),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", type=int, nargs=3, default=(45, 91, 60),
                    help="the paper's grid (unfavorable under its cache)")
    ap.add_argument("--favorable", type=int, nargs=3, default=(64, 91, 60))
    ap.add_argument("--grid", type=int, nargs=3, default=(24, 40, 256),
                    help="the grid the kernel runs on")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    nums = paper_numbers(tuple(args.dims), tuple(args.favorable))
    dims, S = nums["dims"], nums["S"]
    print(f"grid {dims}, cache S={S} words")
    print(f"  shortest lattice vector: {np.array(nums['shortest'])} "
          f"(unfavorable: {nums['unfavorable']})")
    print(f"  padding advisor: {dims} -> {nums['padded']} "
          f"(+{nums['extra_words']} words, shortest "
          f"{nums['shortest_before']} -> {nums['shortest_after']})")
    # Fig. 4 story: on favorable grids cache-fitting wins ~2x; on the
    # unfavorable n1=45 grid it spikes; padding recovers — misses/point is
    # the comparable metric.
    for name, m in nums["misses"].items():
        label = name if name != "favorable" else f"favorable n1={m['dims'][0]}"
        nat, fit, pts = m["natural"], m["cache_fitting"], m["points"]
        print(f"  {label}: natural={nat/pts:.3f}/pt cache-fitting="
              f"{fit/pts:.3f}/pt ratio={nat/fit:.2f}")
    print(f"  bounds (padded grid): lower={nums['lower_bound']:.0f} <= "
          f"measured <= upper={nums['upper_bound']:.0f}")

    # The card: the apply kernel's tile for (64, 128, 512) under the
    # Hopper cost model (shared memory a CTA, modelled time).
    choice = plan_tiles((64, 128, 512), r=2)
    print(f"  Hopper tile for (64,128,512): {choice.tile} sweep axis "
          f"{choice.sweep_axis}, {choice.vmem_bytes} B shared a CTA, "
          f"{choice.ctas_per_sm} CTAs/SM, modeled {choice.modeled_ms:.4f} ms, "
          f"traffic={choice.traffic_bytes/1e6:.1f}MB "
          f"efficiency_vs_isoperimetric={choice.efficiency:.2f}")

    rng = np.random.default_rng(0)
    u = torch.as_tensor(rng.standard_normal(tuple(args.grid))
                        .astype(np.float32)).to(dev)
    offs, w = star_weights_2nd_order(3, 2)
    out = apply_star_2nd_order(u, device=dev)
    ref = stencil_ref(u, offs, w)
    err = float((out - ref).abs().max())
    print(f"  planned kernel max|err| vs oracle: {err:.2e}")
    assert err < 1e-4, err

    # The plan compiler: lattice -> LLL -> unfavorable detection ->
    # padding -> tiling as one cached call.  `python -m
    # repro_torch.plan.explain 45x91x60` prints the full report.
    planner = Planner(cache=PlanCache(persistent=False))
    req = dict(shape=dims, offsets=star_stencil(3, 2), geometry=(2, 512, 4),
               vmem_budget=S * 4, aligned=False)
    plan = planner.plan(**req)
    print(f"  plan compiler: pad {plan.pad.pad} -> {plan.pad.padded_shape}, "
          f"tile {plan.tile} sweep axis {plan.sweep_axis}")
    print(f"    planned/legacy traffic = {plan.traffic_vs_legacy:.3f}, "
          f"efficiency vs isoperimetric bound = {plan.efficiency:.2f}")
    assert planner.plan(**req) == plan  # warm cache hit: no recompute
    print(f"    warm cache hit: {planner.last_plan_seconds * 1e3:.2f} ms "
          f"(stats {planner.cache.stats['hits']} hits / "
          f"{planner.cache.stats['misses']} misses)")

    # The kernel with a plan as the single source of truth.
    grid_plan = planner.plan(shape=tuple(u.shape), offsets=offs)
    out_planned = stencil_pallas(u, offs, w, plan=grid_plan, device=dev)
    err_planned = float((out_planned - ref).abs().max())
    print(f"  kernel from plan (tile {grid_plan.tile}, sweep axis "
          f"{grid_plan.sweep_axis}) max|err| vs oracle: {err_planned:.2e}")
    assert err_planned < 1e-4, err_planned
    return nums


if __name__ == "__main__":
    main()
