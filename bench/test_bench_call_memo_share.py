"""CPU checks of ``call_memo_share`` (``bench/metrics/call_memo_share.py``),
the share of the port's warm calls served by its call memo.

A copy of the benchmark gains a tiny cell by new files and manifest
entries alone, as ``test_bench_manifest.py`` does it, and runs traced on
the CPU: every warm call is a repeat, so the share reads 100%.  A port
without the totals, without a warm call or without the memo's counter
reads nothing and raises nothing.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from bench import harness

ROOT = Path(__file__).resolve().parent.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_two_call_memo_metrics_in_the_manifest():
    by_name = {m["name"]: m for m in MANIFEST["per_layer"]}
    for name, moves, cells in (
            ("call_memo_share", "point_updates_per_s",
             ["star13-apply-512", "box27-iter4-512", "star13-iter4-512",
              "star13bf16-apply-512"]),
            ("call_memo_share.blocks", "point_updates_per_s.blocks",
             ["star13-blocks-128"])):
        m = by_name[name]
        assert (m["moves"], m["workloads"], m["unit"], m["source"]) == (
            moves, cells, "%", "program_counter")
        assert harness.reader(name) is not None


def _copy_with_cell(tmp_path):
    """A copy of the benchmark with a tiny plain-application cell whose
    one per-layer metric is ``call_memo_share``."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    manifest = json.loads(json.dumps(MANIFEST))
    mix = "tiny-memo"
    (tmp_path / f"bench/mixes/{mix}.json").write_text(json.dumps({
        "grid": [16, 16, 20], "entry": "stencil_pallas", "time_steps": 1,
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
        if m["name"] == "call_memo_share":
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return harness.load_cell(name, root=tmp_path), before


def test_call_memo_share_reads_100_on_a_cpu_repeat(tmp_path):
    """Every warm call of a tiny ``stencil_pallas`` cell on the CPU (all
    but the first, cold one) is served by the call memo."""
    from repro_torch import obs

    cell, before = _copy_with_cell(tmp_path)
    obs.reset_totals()
    result = harness.run_cell(cell, 2**40 + 13, 0.2, True, device="cpu")
    assert result["correct"], result["checks"]
    assert result["metrics"]["call_memo_share"] == {"value": 100.0,
                                                    "unit": "%"}
    warm = obs.totals()["warm"]
    assert warm["call_memo.hit"] == warm["stencil_call.n"] > 1
    assert obs.totals()["cold"]["call_memo.miss"] == 1
    for path, data in before.items():
        assert path.read_bytes() == data, path


def test_no_totals_no_warm_call_no_counter_no_reading(monkeypatch):
    from repro_torch import obs

    rec = {"steps_per_call": 1}
    read = harness.reader("call_memo_share")
    obs.reset_totals()
    assert read(rec) is None
    # A port whose totals lack the call memo's counter.
    monkeypatch.setattr(obs, "totals", lambda: {"warm": {
        "stencil_call.n": 4, "stencil_call.ns": 4000}})
    assert read(rec) is None
    monkeypatch.delattr(obs, "totals")
    assert read(rec) is None
