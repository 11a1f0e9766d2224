"""CPU checks of the per-layer metrics read from the port's own stage totals
(``bench/program_totals.py`` and its six readers under ``bench/metrics/``).

A copy of the benchmark gains a tiny cell by new files and manifest
entries alone, as ``test_bench_manifest.py`` does it, and runs traced on
the CPU: every reader reports, the stage metrics add up to the call, and
``enqueued_ops_per_step`` is the path's own count of device operations.
A port without the totals reads nothing and raises nothing.
"""

from __future__ import annotations

import json
import math
import shutil
from pathlib import Path

import pytest

from bench import harness

ROOT = Path(__file__).resolve().parent.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
PROGRAM = ["call_ms_per_call", "frontend_ms_per_call", "decide_ms_per_call",
           "buffers_host_ms_per_call", "launch_host_ms_per_call",
           "enqueued_ops_per_step"]
STAGE_PARTS = PROGRAM[1:5]
BIG = ["star13-apply-512", "box27-iter4-512", "star13-iter4-512"]


def test_the_twelve_program_metrics_in_the_manifest():
    by_name = {m["name"]: m for m in MANIFEST["per_layer"]}
    for name in PROGRAM:
        for suffix, moves, cells in (
                ("", "point_updates_per_s", BIG),
                (".blocks", "point_updates_per_s.blocks",
                 ["star13-blocks-128"])):
            m = by_name[name + suffix]
            assert m["moves"] == moves and m["workloads"] == cells
            assert m["source"] == ("program_counter"
                                   if name == "enqueued_ops_per_step"
                                   else "program_span")
            assert m["unit"] == ("launches" if name == "enqueued_ops_per_step"
                                 else "ms")
            assert harness.reader(m["name"]) is not None


def _copy_with_cell(tmp_path, entry, steps):
    """A copy of the benchmark with a tiny cell ``tiny-<entry>`` whose
    per-layer metrics are the six program metrics."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    manifest = json.loads(json.dumps(MANIFEST))
    mix = f"tiny-{entry}"
    (tmp_path / f"bench/mixes/{mix}.json").write_text(json.dumps({
        "grid": [16, 16, 20], "entry": entry, "time_steps": steps,
        "blocks": 2, "calls_per_request": 2, "checked_calls": 2,
        "fresh_calls": 2,
    }))
    name = f"star13-{mix}"
    manifest["workloads"].append({
        "name": name, "config": "star3d2r-f32", "traffic": mix,
        "chips": 1, "why": "a test"})
    for m in manifest["end_to_end"]:
        if m["name"] in ("point_updates_per_s", "request_p95_ms"):
            m["workloads"].append(name)
    for m in manifest["per_layer"]:
        if m["name"] in PROGRAM:
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return harness.load_cell(name, root=tmp_path), before


@pytest.mark.parametrize("entry,steps", [("stencil_pallas", 1),
                                         ("stencil_iterate", 4)])
def test_the_program_metrics_read_the_ports_totals(tmp_path, entry, steps):
    from repro_torch import obs

    cell, before = _copy_with_cell(tmp_path, entry, steps)
    assert {m["name"] for m in cell["per_layer"]} >= set(PROGRAM)
    obs.reset_totals()
    result = harness.run_cell(cell, 2**40 + 11, 0.2, True, device="cpu")
    assert result["correct"], result["checks"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(PROGRAM) <= set(got)
    for name in PROGRAM:
        assert math.isfinite(got[name]) and got[name] > 0, name
    parts = sum(got[k] for k in STAGE_PARTS)
    assert parts <= got["call_ms_per_call"]

    # The path's own count: a call's launches (its kernel_launch spans),
    # each a fill, a copy-in and a kernel, and a trim where the tile's
    # round-up leaves a slice that is not contiguous.
    call = harness.port_entry(cell, *harness.inputs(
        cell["config"], cell["mix"], 5, "cpu")[:2], "cpu")
    with obs.recording() as rec:
        call(harness.inputs(cell["config"], cell["mix"], 5, "cpu")[2][0])
    launches = [s for s in rec.spans if s.name == "kernel_launch"]
    grid = cell["mix"]["grid"]
    trims = sum(
        any(-(-n // t) * t != n for n, t in zip(grid[1:], s.args["tile"][1:]))
        for s in launches)
    assert got["enqueued_ops_per_step"] == (3 * len(launches) + trims) / steps
    for path, data in before.items():
        assert path.read_bytes() == data, path


def test_no_totals_no_warm_call_no_reading(monkeypatch):
    from repro_torch import obs

    rec = {"steps_per_call": 1}
    obs.reset_totals()
    for name in PROGRAM:
        assert harness.reader(name)(rec) is None, name
    monkeypatch.delattr(obs, "totals")
    for name in PROGRAM:
        assert harness.reader(name)(rec) is None, name
