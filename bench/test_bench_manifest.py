"""CPU checks of ``BENCHMARK.json`` and the files the harness finds by name.

Run with the repository's tests (``python -m pytest`` from the root); none
needs a card.
"""

from __future__ import annotations

import json
import math
import re
import shutil
from pathlib import Path

import pytest

from bench import harness

ROOT = Path(__file__).resolve().parent.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_manifest_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "bench/run.py"]
    assert MANIFEST["paths"] == ["bench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_names_units_and_lines_use_the_allowed_characters():
    entries = (MANIFEST["configs"] + MANIFEST["workloads"]
               + MANIFEST["end_to_end"] + MANIFEST["per_layer"])
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for c in MANIFEST["configs"]:
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert LINE.match(m["layer"])
    assert all(LINE.match(word) for word in MANIFEST["command"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = harness.load_cell(cell)
    assert c["chips"] == 1
    work = {w["name"]: w for w in MANIFEST["workloads"]}[cell]
    entry = {e["name"]: e for e in MANIFEST["configs"]}[work["config"]]
    assert entry["file"].startswith("bench/configs/")
    assert c["config"]["name"] == entry["name"]
    assert c["config"]["source"] == entry["source"]
    assert c["config"]["reduced"] == entry["reduced"]
    for key in ("grid", "entry", "time_steps", "blocks",
                "calls_per_request", "checked_calls", "fresh_calls"):
        assert key in c["mix"], key
    assert (ROOT / "bench" / "entries" / f"{c['mix']['entry']}.py").exists()
    for key in ("weight_rule", "boundary", "dtype"):
        assert key in c["config"], key
    assert c["config"]["weight_rule"] in harness.WEIGHT_RULES
    assert set(c["config"]["check"]) == {"max_rel_err", "control_dtype"}
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"], "every cell reports a per-layer metric"


def test_every_config_is_used_and_files_are_distinct():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize(
    "metric", MANIFEST["end_to_end"] + MANIFEST["per_layer"],
    ids=lambda m: m["name"],
)
def test_metric_has_a_reader_and_names_cells_that_report_what_it_moves(
        metric):
    assert callable(harness.reader(metric["name"]))
    cells = metric.get("workloads", CELLS)
    assert set(cells) <= set(CELLS)
    if "moves" in metric:
        moved = {m["name"]: m for m in MANIFEST["end_to_end"]}[
            metric["moves"]]
        assert set(cells) <= set(moved.get("workloads", CELLS))


def test_run_seconds_fit_the_check_with_the_full_24_cells():
    runs = 2 + 14 * 24
    total = runs * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) == 0


def test_a_new_config_mix_and_metric_need_only_new_files(tmp_path):
    """A copy of the benchmark gains a configuration (with its own control
    precision), a mix, an entry, a per-layer metric and a cell by new
    files and manifest entries alone; the cell then runs on the CPU at a
    tiny size through the new entry and reports the new metric, its
    control fails, and no file the copy already had is changed."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    manifest = json.loads(json.dumps(MANIFEST))
    star = json.loads((ROOT / "bench/configs/star3d2r-f32.json").read_text())
    star.update(name="star3d1r-f32",
                operator={"kind": "star", "radius": 1, "taps": 7},
                check={"max_rel_err": 2e-4, "control_dtype": "float16"})
    (tmp_path / "bench/configs/star3d1r-f32.json").write_text(
        json.dumps(star))
    (tmp_path / "bench/mixes/tiny-2x3.json").write_text(json.dumps({
        "grid": [14, 16, 18], "entry": "stencil_pallas_steps",
        "time_steps": 2, "blocks": 2, "calls_per_request": 3,
        "checked_calls": 3, "fresh_calls": 2,
    }))
    (tmp_path / "bench/entries/stencil_pallas_steps.py").write_text(
        "import numpy as np\n"
        "def make(config, mix, taps, weights, device):\n"
        "    from repro_torch.kernels import stencil as st\n"
        "    offs = np.asarray(taps, dtype=np.int64)\n"
        "    def call(u):\n"
        "        for _ in range(int(mix['time_steps'])):\n"
        "            u = st.stencil_pallas(u, offs, weights,\n"
        "                                  device=str(device))\n"
        "        return u\n"
        "    return call\n"
    )
    (tmp_path / "bench/metrics/calls_per_request.py").write_text(
        "def read(rec):\n"
        "    return len(rec['calls']) / len(rec['requests'])\n"
    )
    manifest["configs"].append({
        "name": "star3d1r-f32", "source": "the 7-point star",
        "file": "bench/configs/star3d1r-f32.json", "reduced": [],
        "why": "a test"})
    manifest["workloads"].append({
        "name": "star7-tiny", "config": "star3d1r-f32",
        "traffic": "tiny-2x3", "chips": 1, "why": "a test"})
    for m in manifest["end_to_end"]:
        if m["name"] in ("point_updates_per_s", "request_p95_ms"):
            m["workloads"].append("star7-tiny")
    manifest["per_layer"].append({
        "name": "calls_per_request", "unit": "calls", "better": "lower",
        "source": "host_clock", "layer": "the whole step",
        "moves": "point_updates_per_s", "workloads": ["star7-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = harness.load_cell("star7-tiny", root=tmp_path)
    result = harness.run_cell(cell, 2**40 + 3, 0.2, True, device="cpu")
    assert result["correct"], result["checks"]
    control = harness.run_cell(cell, 2**40 + 4, 0.2, False, device="cpu",
                               entry=harness.control_entry)
    assert not control["correct"], control["checks"]
    assert result["metrics"]["calls_per_request"]["value"] == 3
    result = harness.run_cell(cell, 2**40 + 3, 0.2, False, device="cpu")
    assert result["correct"]
    assert math.isfinite(result["metrics"]["point_updates_per_s"]["value"])
    assert set(result["metrics"]) == {"point_updates_per_s",
                                      "request_p95_ms", "setup_s"}
    for path, data in before.items():
        assert path.read_bytes() == data, path
