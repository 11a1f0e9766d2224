"""``python -m repro_torch.obs.report trace.json`` — reconcile a recorded trace.

Reads a ``trace_event`` JSON file written by :mod:`repro_torch.obs` and
prints the evidence trail the plan promises:

* a per-launch table — plan key, fused depth, shard count, tile, window
  kind, frontier shared memory, modelled bytes and modelled ms, and the
  span's host time — one row per ``kernel_launch`` span;
* the tune-race outcome (candidate ranks, measured medians, winner);
* the counter totals (cache hits/misses, modelled totals).

A ``kernel_launch`` span times the host's enqueue of the launch, not the
kernel: on the card the kernel runs after the span has closed.  So the
table gives no rate computed from a span; device times come from
``torch.profiler`` (each span opens a ``record_function`` range of its
name, under which the profiler files the kernels it launched) or from the
tune loop's ``measure``, which synchronizes.

``--check`` additionally asserts the internal bookkeeping reconciles —
the ``launches`` counter matches the number of launch spans, the summed
per-span ``modeled_bytes``, ``modeled_flops`` and ``ring_smem_bytes`` (the
frontier part of each launch's shared memory) match their counters, the
summed ``halo_exchange`` span bytes match ``halo_exchange_bytes``, and
the summed ``measure`` span nanoseconds match ``measured_ns`` — exiting
non-zero on any mismatch.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any

from .trace_event import load_trace

__all__ = ["main", "reconcile", "render", "summarize"]


def _spans(doc: dict, name: str) -> list[dict]:
    return [
        ev for ev in doc["traceEvents"]
        if ev.get("ph") == "X" and ev.get("name") == name
    ]


def _counters(doc: dict) -> dict[str, int]:
    # Prefer the final totals stashed by the exporter; fall back to the
    # last ph:"C" sample per counter for traces from other producers.
    other = doc.get("otherData") or {}
    if isinstance(other.get("counters"), dict):
        return dict(other["counters"])
    totals: dict[str, int] = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "C":
            for k, v in (ev.get("args") or {}).items():
                totals[k] = v
    return totals


def summarize(doc: dict) -> dict[str, Any]:
    """Digest a trace into the report's row data (pure, testable)."""
    counters = _counters(doc)
    launches = []
    for ev in _spans(doc, "kernel_launch"):
        args = ev.get("args") or {}
        launches.append({
            "plan_key": str(args.get("plan_key", "?")),
            "device": args.get("device"),
            "fused_depth": args.get("fused_depth"),
            "num_shards": args.get("num_shards"),
            "tile": args.get("tile"),
            "sweep_axis": args.get("sweep_axis"),
            "steps": args.get("steps"),
            "modeled_bytes": int(args.get("modeled_bytes", 0)),
            "modeled_flops": int(args.get("modeled_flops", 0)),
            "modeled_ms": float(args.get("modeled_ms", 0.0)),
            "window_kind": args.get("window_kind"),
            "stage_dtypes": args.get("stage_dtypes"),
            "ring_smem_bytes": int(args.get("ring_smem_bytes", 0)),
            "host_us": float(ev.get("dur", 0.0)),
        })
    races = []
    for ev in _spans(doc, "tune_race"):
        args = ev.get("args") or {}
        races.append({
            "key": str(args.get("plan_key", "?")),
            "candidates": args.get("candidates"),
            "winner_rank": args.get("winner_rank"),
            "winner_source": args.get("source"),
            "dur_us": float(ev.get("dur", 0.0)),
        })
    candidates = []
    for ev in _spans(doc, "tune_candidate"):
        args = ev.get("args") or {}
        candidates.append({
            "rank": args.get("rank"),
            "tile": args.get("tile"),
            "fused_depth": args.get("fused_depth"),
            "modeled_ms": args.get("modeled_ms"),
            "median_ms": args.get("median_ms"),
            "dur_us": float(ev.get("dur", 0.0)),
        })
    measures = _spans(doc, "measure")
    exchanges = _spans(doc, "halo_exchange")
    return {
        "counters": counters,
        "launches": launches,
        "races": races,
        "candidates": candidates,
        "n_plan_spans": len(_spans(doc, "plan")),
        "n_measure_spans": len(measures),
        "n_exchange_spans": len(exchanges),
        "exchange_bytes_total": int(
            sum((x.get("args") or {}).get("exchange_bytes", 0)
                for x in exchanges)
        ),
        "measure_ns_total": int(
            sum((m.get("args") or {}).get("measured_ns", 0) for m in measures)
        ),
    }


def reconcile(summary: dict[str, Any]) -> list[str]:
    """Cross-check counters against spans; returns mismatch messages."""
    problems: list[str] = []
    c = summary["counters"]
    launches = summary["launches"]
    n_counter = int(c.get("launches", 0))
    if n_counter != len(launches):
        problems.append(
            f"launches counter={n_counter} but {len(launches)} "
            f"kernel_launch spans recorded"
        )
    for field in ("modeled_bytes", "modeled_flops", "ring_smem_bytes"):
        span_sum = sum(l[field] for l in launches)
        if span_sum != int(c.get(field, 0)):
            problems.append(
                f"{field} counter={c.get(field, 0)} but launch spans sum "
                f"to {span_sum}"
            )
    if summary["exchange_bytes_total"] != int(c.get("halo_exchange_bytes", 0)):
        problems.append(
            f"halo_exchange_bytes counter={c.get('halo_exchange_bytes', 0)} "
            f"but halo_exchange spans sum to "
            f"{summary['exchange_bytes_total']}"
        )
    if summary["measure_ns_total"] != int(c.get("measured_ns", 0)):
        problems.append(
            f"measured_ns counter={c.get('measured_ns', 0)} but measure "
            f"spans sum to {summary['measure_ns_total']}"
        )
    return problems


def _fmt_bytes(n: int) -> str:
    for unit, div in (("GiB", 2**30), ("MiB", 2**20), ("KiB", 2**10)):
        if n >= div:
            return f"{n / div:.2f} {unit}"
    return f"{n} B"


def render(summary: dict[str, Any]) -> str:
    lines: list[str] = []
    launches = summary["launches"]
    lines.append(f"launches: {len(launches)}")
    if launches:
        hdr = (
            f"{'#':>3}  {'plan key':<14} {'dev':<4} {'T':>3} {'shards':>6} "
            f"{'tile':<14} {'win':<5} {'ring smem':>10} "
            f"{'modeled':>12} {'model ms':>9} {'host ms':>9}"
        )
        lines += [hdr, "-" * len(hdr)]
        for i, l in enumerate(launches):
            tile = "x".join(map(str, l["tile"])) if l["tile"] else "-"
            wk = (l.get("window_kind") or "-")[:5]
            lines.append(
                f"{i:>3}  {l['plan_key'][:14]:<14} "
                f"{str(l['device'] or '-')[:4]:<4} "
                f"{l['fused_depth'] or 1:>3} {l['num_shards'] or 1:>6} "
                f"{tile:<14} {wk:<5} "
                f"{_fmt_bytes(l['ring_smem_bytes']):>10} "
                f"{_fmt_bytes(l['modeled_bytes']):>12} "
                f"{l['modeled_ms']:>9.4f} {l['host_us'] / 1e3:>9.3f}"
            )
            dts = l.get("stage_dtypes")
            if dts and any(dt is not None for dt in dts):
                lines.append(
                    "     stage dtypes: "
                    + " -> ".join(dt or "<input>" for dt in dts)
                )
        lines.append(
            "  (host ms: the span, i.e. the enqueue; not the kernel's time)"
        )
    for race in summary["races"]:
        lines.append(
            f"tune race: key={race['key'][:14]} "
            f"candidates={race['candidates']} "
            f"winner_rank={race['winner_rank']} "
            f"source={race['winner_source']} "
            f"({race['dur_us'] / 1e3:.1f} ms)"
        )
    for cand in summary["candidates"]:
        tile = "x".join(map(str, cand["tile"])) if cand["tile"] else "-"
        med = cand["median_ms"]
        lines.append(
            f"  candidate rank={cand['rank']} tile={tile} "
            f"T={cand['fused_depth']} modeled={cand['modeled_ms']} ms "
            f"median={med:.4f} ms" if isinstance(med, (int, float))
            else f"  candidate rank={cand['rank']} tile={tile}"
        )
    lines.append(
        f"spans: plan={summary['n_plan_spans']} "
        f"measure={summary['n_measure_spans']} "
        f"halo_exchange={summary['n_exchange_spans']}"
    )
    counters = summary["counters"]
    if counters:
        lines.append("counters:")
        for name in sorted(counters):
            lines.append(f"  {name:<24} {counters[name]}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Reconcile a repro_torch.obs trace_event JSON file.",
    )
    ap.add_argument("trace",
                    help="path to a REPRO_TORCH_TRACE/recording() output")
    ap.add_argument(
        "--check",
        action="store_true",
        help="exit non-zero unless counters reconcile against spans",
    )
    ap.add_argument(
        "--json",
        action="store_true",
        help="emit the summary as JSON instead of a table",
    )
    ns = ap.parse_args(argv)
    try:
        doc = load_trace(ns.trace)
    except (OSError, ValueError, json.JSONDecodeError) as exc:
        print(f"repro_torch.obs.report: invalid trace {ns.trace!r}: {exc}",
              file=sys.stderr)
        return 2
    summary = summarize(doc)
    problems = reconcile(summary)
    if ns.json:
        print(json.dumps(
            {"summary": summary, "reconciled": not problems,
             "problems": problems},
            indent=2, default=str,
        ))
    else:
        print(render(summary))
        if problems:
            print("RECONCILIATION MISMATCH:")
            for p in problems:
                print(f"  {p}")
        else:
            print("reconciled: counters match spans")
    if ns.check and problems:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
