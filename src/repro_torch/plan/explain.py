"""Human-readable plan reports:  python -m repro_torch.plan.explain 45x91x24

Prints the pipeline for one grid — interference-lattice basis, LLL
reduction, shortest vector, why a pad was (not) chosen, the winning tile,
sweep axis, fusion depth and window kind, the kernel that runs it with its
shared memory, CTAs per SM and waves, the per-depth table (modelled chain
time, traffic and streaming flops per candidate fusion depth), and the
modelled time and traffic against the legacy heuristic, the planner's own
single-pass choice and the isoperimetric lower bound, on the card the
request names (the published H100 SXM figures by default).

``--num-shards N`` plans the column-sharded launch (per-shard figures
and the halo-exchange bytes).

``--smoke`` runs the gates: eight requests (one favorable and one
unfavorable grid under the paper's (2, 512, 4) cache, the 13-point star
at 512³, the same star three times at 512³, a two-stage heterogeneous
chain, a bf16 ring chain against its forced trapezoid, the star at 256³
over 4 shards, and Mamba2's prefill conv grid), asserting that the pad
triggers exactly on the unfavorable grid and clears it, efficiency ≤ 1,
the planner never models slower than the legacy heuristic or than its own
single-pass plan, the ring admits every depth the trapezoid does and
never models slower, every emitted tile fits its kernel's shared memory,
the T = 3 star at 512³ does not fuse on an H100, a shard's slab moves at
most half the whole grid's bytes (and 1 shard is the unsharded plan), and
a warm cache hit takes under 1 ms.

``--tuned`` also prints the measured candidate table the tune loop
(``python -m repro_torch.plan.tune``) stored for the request, if any:
``--device cuda`` for the card's records (planned for the card), else the
CPU's.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..core.cache_fitting import box_stencil, star_stencil
from .cache import PlanCache
from .planner import Planner
from .schema import StencilPlan

__all__ = ["format_plan", "main", "plan_json_doc", "smoke"]


def _parse_shape(s: str) -> tuple[int, ...]:
    for sep in ("x", ","):
        if sep in s:
            return tuple(int(p) for p in s.split(sep) if p)
    return (int(s),)


def _parse_stencil(spec: str, d: int) -> np.ndarray:
    kind, _, r = spec.partition(":")
    r = int(r or 2)
    if kind == "star":
        return star_stencil(d, r)
    if kind == "box":
        return box_stencil(d, r)
    raise SystemExit(f"unknown stencil spec {spec!r} (use star:R or box:R)")


def _fmt_bytes(b: float) -> str:
    if b >= 1 << 20:
        return f"{b / (1 << 20):.2f} MiB"
    if b >= 1 << 10:
        return f"{b / (1 << 10):.2f} KiB"
    return f"{b:.0f} B"


def format_plan(plan: StencilPlan, validation: dict | None = None) -> str:
    req = plan.request
    lines = [
        f"plan for grid {req.shape}  (dtype {req.dtype_bytes} B, "
        f"{len(req.offsets)} RHS, shared budget "
        f"{_fmt_bytes(req.vmem_budget)} per CTA, strategy {req.strategy})",
        f"  card: {req.hardware[0]}, {req.hardware[1]} SMs",
    ]
    lat = plan.lattice
    if lat is not None:
        lines += [
            f"  cache model: S = {lat.S} words "
            f"(geometry a,z,w = {req.geometry})",
            "  interference lattice (Eq. 9 basis rows):",
        ]
        lines += [f"    {row}" for row in lat.basis]
        lines.append("  LLL-reduced basis:")
        lines += [f"    {row}" for row in lat.reduced]
        lines += [
            f"  shortest vector: {lat.shortest}  |v|_1 = {lat.shortest_l1:.0f}"
            f"  |v|_2 = {lat.shortest_l2:.2f}  eccentricity {lat.eccentricity:.2f}",
            f"  unfavorable: {lat.unfavorable}  "
            f"(threshold |v|_1 < {lat.threshold:.3g}; Fig. 5 hyperbola "
            f"k = {lat.hyperbola_k}, rel. dist {lat.hyperbola_dist:.3f})",
        ]
    else:
        lines.append("  cache model: none (windows in shared memory)")
    n_launch = -(-plan.time_steps // plan.fused_depth)
    lines += [
        f"  pad: {plan.pad.pad} -> {plan.pad.padded_shape} "
        f"(+{plan.pad.extra_words} words)",
        f"    why: {plan.pad.reason}",
        f"  tile: {plan.tile}  sweep axis {plan.sweep_axis}  "
        f"grid {plan.grid}  pipelined {plan.pipelined}",
        f"  kernel: sweep_{plan.kernel}, {_fmt_bytes(plan.vmem_bytes)} shared "
        f"per CTA, {plan.ctas_per_sm} CTA(s) per SM, {plan.waves:.3f} waves",
    ]
    if plan.time_steps > 1:
        distinct = len({st.offsets for st in req.stages})
        lines.append(
            f"  stage chain: {plan.time_steps} applications "
            f"({distinct} distinct operator(s)), fused depth "
            f"{plan.fused_depth} ({n_launch} launch(es); "
            f"{plan.window_kind} frontier windows)"
        )
        dts = [st.dtype for st in req.stages]
        if any(dt is not None for dt in dts):
            lines.append(
                "  stage dtypes: "
                + " -> ".join(dt or "<input>" for dt in dts)
            )
    if plan.num_shards > 1:
        lines.append(
            f"  sharding: {plan.num_shards} shards over axis "
            f"{plan.shard_axis} (mesh axis {req.mesh_axis!r}); per-shard "
            f"traffic {_fmt_bytes(plan.per_shard_traffic_bytes)}, halo "
            f"exchange {_fmt_bytes(plan.halo_exchange_bytes)} (all figures "
            "below are one shard's column slab)"
        )
    if len(plan.depth_ms) > 1:
        lines.append("  fused-depth scores (whole chain, modelled):")
        lines.append("    depth   time ms        traffic  flops(streaming)"
                     "  chosen")
        for (depth, ms), (_, tr, fl) in zip(plan.depth_ms, plan.depth_scores):
            mark = "   <--" if depth == plan.fused_depth else ""
            lines.append(
                f"    {depth:>5}  {ms:>8.4f}  {_fmt_bytes(tr):>13}  "
                f"{fl:>16,}{mark}"
            )
    if req.program:
        from ..ir import summarize_program

        lines.append(f"  program: {summarize_program(req.program)}")
    lines += [
        f"  modelled time: {plan.modeled_ms:.4f} ms  "
        f"(legacy heuristic {plan.legacy_modeled_ms:.4f} ms, tile "
        f"{plan.legacy_tile}; own single-pass "
        f"{plan.single_pass_modeled_ms:.4f} ms)",
        f"  predicted traffic: {_fmt_bytes(plan.traffic_bytes)} "
        f"({plan.traffic_bytes // max(req.dtype_bytes, 1)} loads); "
        f"surface/volume {plan.surface_to_volume:.3f}",
        f"    vs isoperimetric lower bound: "
        f"{_fmt_bytes(plan.lower_bound_bytes)} -> efficiency = "
        f"{plan.efficiency:.3f}",
    ]
    if validation and validation.get("validated"):
        o = validation["original"]
        p = validation["padded"]
        lines.append(
            f"  cache-sim check: original {o['dims']} "
            f"{o['miss_per_point']:.3f} miss/pt, padded {p['dims']} "
            f"{p['miss_per_point']:.3f} miss/pt"
            + (
                f" ({validation['miss_reduction_x']:.2f}x fewer)"
                if "miss_reduction_x" in validation
                else ""
            )
        )
    return "\n".join(lines)


def plan_json_doc(plan: StencilPlan) -> dict:
    """The ``--json`` document: the full frozen plan (round-trips through
    ``StencilPlan.from_dict``), the request's canonical stencil program with
    its inferred per-value bounds, the per-depth score table, and the
    sharding fields a trace's launch rows carry (``modeled_bytes``: every
    shard's traffic plus the exchange)."""
    program = value_bounds = None
    if plan.request.program:
        from ..ir import Program, infer_bounds

        prog = Program.from_json(plan.request.program)
        program = prog.to_dict()
        value_bounds = {
            name: b.to_dict()
            for name, b in infer_bounds(prog, plan.request.shape).items()
        }
    return {
        "plan": plan.to_dict(),
        "program": program,
        "value_bounds": value_bounds,
        "depth_scores": [
            {
                "depth": d,
                "modeled_ms": ms,
                "traffic_bytes": tr,
                "streaming_flops": fl,
                "chosen": d == plan.fused_depth,
            }
            for (d, ms), (_, tr, fl) in zip(plan.depth_ms, plan.depth_scores)
        ],
        "sharding": {
            "num_shards": plan.num_shards,
            "shard_axis": plan.shard_axis,
            "per_shard_traffic_bytes": plan.per_shard_traffic_bytes,
            "halo_exchange_bytes": plan.halo_exchange_bytes,
            "modeled_bytes": (plan.per_shard_traffic_bytes * plan.num_shards
                              + plan.halo_exchange_bytes),
        },
    }


def _check(plan: StencilPlan, name: str) -> None:
    """The invariants every emitted plan keeps."""
    from ..core.tiling import SMEM_BLOCK_LIMIT

    assert plan.efficiency <= 1.0, (name, plan.efficiency)
    assert plan.modeled_ms <= plan.legacy_modeled_ms, (
        name, plan.modeled_ms, plan.legacy_modeled_ms)
    assert plan.modeled_ms <= plan.single_pass_modeled_ms, (
        name, plan.modeled_ms, plan.single_pass_modeled_ms)
    assert plan.modeled_flops <= plan.recompute_flops, name
    assert 0 < plan.vmem_bytes <= min(plan.request.vmem_budget,
                                      SMEM_BLOCK_LIMIT), (name, plan.vmem_bytes)
    assert plan.ctas_per_sm >= 1, name


def smoke() -> int:
    """The gates of the module docstring; returns 0 or raises."""
    import time

    from ..core.padding import is_unfavorable

    planner = Planner(cache=PlanCache(persistent=False))
    offs = star_stencil(3, 2)
    geom = (2, 512, 4)
    S = geom[0] * geom[1] * geom[2]
    conv = [[(-i, 0) for i in range(4)]]
    cases = [
        ("favorable", dict(shape=(64, 91, 60), geometry=geom,
                           vmem_budget=16 * 1024, aligned=False,
                           offsets=offs)),
        # n1*n2 ~ 2*(S/2), Fig. 5
        ("unfavorable", dict(shape=(45, 91, 24), geometry=geom,
                             vmem_budget=16 * 1024, aligned=False,
                             offsets=offs)),
        ("apply_512", dict(shape=(512,) * 3, offsets=offs)),
        # Three applications beat the fused chain on the card: no fusion.
        ("t3_512", dict(shape=(512,) * 3, offsets=offs, time_steps=3)),
        ("stage_chain_2", dict(shape=(128, 128, 128),
                               stages=[star_stencil(3, 1), offs])),
        ("ring_bf16", dict(shape=(256,) * 3, offsets=offs, time_steps=4,
                           dtypes=["bfloat16"] * 3 + ["float32"])),
        # Column sharding: the planner tiles the worst shard's slab, which
        # must move well under the whole grid's bytes.
        ("sharded_4", dict(shape=(256,) * 3, offsets=offs, num_shards=4)),
        ("conv", dict(shape=(2048, 5376), offsets=conv, dtype_bytes=2,
                      n_operands=2)),
    ]
    for name, kw in cases:
        plan = planner.plan(**kw)
        _check(plan, name)
        if name == "unfavorable":
            assert plan.pad.nonzero, "pad did not trigger on unfavorable grid"
            assert not is_unfavorable(plan.pad.padded_shape, S, diameter=5), (
                "padded grid still unfavorable")
        if name == "favorable":
            assert not plan.pad.nonzero, "pad triggered on favorable grid"
        if name == "t3_512":
            assert plan.fused_depth == 1, plan.depth_ms
            assert len(plan.depth_ms) == 3, plan.depth_ms
        if name == "stage_chain_2":
            assert plan.time_steps == 2 and len(plan.request.stages) == 2
        if name == "ring_bf16":
            assert plan.window_kind == "ring", plan.window_kind
            assert [st.dtype for st in plan.request.stages] == \
                ["bfloat16"] * 3 + [None]
            trap = planner.plan(**dict(kw, window_kind="trapezoid"))
            _check(trap, name + "_trapezoid")
            assert plan.modeled_ms <= trap.modeled_ms
            assert {d for d, _ in plan.depth_ms} >= \
                {d for d, _ in trap.depth_ms}, (plan.depth_ms, trap.depth_ms)
        if name == "sharded_4":
            base = planner.plan(**dict(kw, num_shards=1))
            assert plan.num_shards == 4 and plan.shard_axis is not None
            assert plan.shard_axis != plan.sweep_axis
            assert plan.halo_exchange_bytes > 0
            assert plan.per_shard_traffic_bytes == plan.traffic_bytes
            # The per-card win: one shard's slab moves well under the
            # whole grid's bytes (ideally a quarter).
            assert plan.per_shard_traffic_bytes <= base.traffic_bytes / 2, (
                plan.per_shard_traffic_bytes, base.traffic_bytes)
            # 1 shard is the unsharded request: same plan, same key.
            assert base == planner.plan(**{k: v for k, v in kw.items()
                                           if k != "num_shards"})
            assert plan.request.cache_key() != base.request.cache_key()
        warm = []
        for _ in range(3):  # best-of-3: absorb one-time warmup/GC noise
            t0 = time.perf_counter()
            again = planner.plan(**kw)
            warm.append((time.perf_counter() - t0) * 1e3)
            assert again == plan
        warm_ms = min(warm)
        assert warm_ms < 1.0, f"warm cache hit took {warm_ms:.2f} ms"
        print(
            f"planner smoke [{name}] {plan.request.shape}: pad={plan.pad.pad} "
            f"tile={plan.tile} sweep={plan.sweep_axis} "
            f"depth={plan.fused_depth} kernel={plan.kernel} "
            f"smem={plan.vmem_bytes} ctas/SM={plan.ctas_per_sm} "
            f"modeled={plan.modeled_ms:.4f} ms "
            f"legacy={plan.legacy_modeled_ms:.4f} ms "
            f"warm_hit={warm_ms:.3f} ms  OK"
        )
    print("planner smoke: all gates passed")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.plan.explain",
        description="Explain the stencil plan for one grid.",
    )
    ap.add_argument("shape", nargs="?", default="45x91x24",
                    help="grid shape, e.g. 45x91x24")
    ap.add_argument("--stencil", default="star:2",
                    help="star:R or box:R (default star:2)")
    ap.add_argument("--geom", default="2,512,4",
                    help="cache geometry a,z,w; 'none' to skip steps 1-3")
    ap.add_argument("--budget", type=int, default=None,
                    help="shared-memory bytes per CTA (default 227 KB)")
    ap.add_argument("--dtype-bytes", type=int, default=4)
    ap.add_argument("--num-shards", type=int, default=1,
                    help="plan the column-sharded launch over N devices")
    ap.add_argument("--time-steps", type=int, default=1,
                    help="apply the stencil T times (fused where it pays)")
    ap.add_argument("--window-kind", default="auto",
                    choices=("auto", "ring", "trapezoid"),
                    help="frontier layout (auto races both)")
    ap.add_argument("--dtypes", default=None,
                    help="comma-separated per-stage output dtypes for a "
                    "--time-steps chain, e.g. bfloat16,bfloat16,float32")
    ap.add_argument("--unaligned", action="store_true",
                    help="free tile extents (no 128-byte minor grain)")
    ap.add_argument("--legacy", action="store_true",
                    help="use the legacy strategy (default candidates, "
                    "depth 1)")
    ap.add_argument("--validate", action="store_true",
                    help="cache-simulate original vs padded grid")
    ap.add_argument("--tuned", action="store_true",
                    help="show the TunedPlanDB record for this request "
                    "(measured candidate table), if one exists")
    ap.add_argument("--device", default=None,
                    help="with --tuned: the device the record was measured "
                    "on (cuda plans for this card; default: the CPU's "
                    "record, planned with the published H100 figures)")
    ap.add_argument("--db", default=None,
                    help="tuned-plan DB directory for --tuned (default: "
                    "REPRO_TORCH_TUNED_DB_DIR or ~/.cache/repro_torch/tuned)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output: the full plan and the "
                    "depth-score table")
    ap.add_argument("--smoke", action="store_true",
                    help="run the smoke gates instead")
    args = ap.parse_args(argv)
    if args.smoke:
        return smoke()

    shape = _parse_shape(args.shape)
    offs = _parse_stencil(args.stencil, len(shape))
    geometry = None if args.geom.lower() == "none" else _parse_shape(args.geom)
    planner = Planner(strategy="legacy" if args.legacy else "paper",
                      cache=PlanCache(persistent=False))
    hardware = None
    if args.device is not None:
        from .. import resolve_device
        from ..kernels.stencil import _planning_hardware

        hardware = _planning_hardware(resolve_device(args.device))
    plan = planner.plan(
        shape=shape, offsets=offs, dtype_bytes=args.dtype_bytes,
        vmem_budget=args.budget, geometry=geometry,
        aligned=not args.unaligned, time_steps=args.time_steps,
        num_shards=args.num_shards,
        window_kind=args.window_kind,
        dtypes=args.dtypes.split(",") if args.dtypes else None,
        hardware=hardware,
    )
    if args.json:
        print(json.dumps(plan_json_doc(plan), indent=2, sort_keys=True))
        return 0
    validation = planner.validate(plan) if args.validate else None
    print(format_plan(plan, validation))
    if args.tuned:
        from .tune import backend_fingerprint, format_record
        from .tunedb import TunedPlanDB

        fp = backend_fingerprint(args.device or "cpu")
        rec = TunedPlanDB(db_dir=args.db).get(plan.request.cache_key(), fp)
        if rec is None:
            dev = f" --device {args.device}" if args.device else " --device cpu"
            print(
                f"\ntuned: no record for this request at fingerprint {fp}\n"
                "  (run `python -m repro_torch.plan.tune "
                f"{args.shape} --stencil {args.stencil}{dev}` to measure one)"
            )
        else:
            print("\ntuned record (measured candidates):")
            print(format_record(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
