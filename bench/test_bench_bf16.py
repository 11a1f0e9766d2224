"""CPU checks of the bfloat16 configuration ``star3d2r-bf16``, its cell
``star13bf16-apply-512`` and the row-path shares ``copy16_share`` and
``span_share``.

The cell runs at a tiny size on the port's plain versions: a sound run is
correct, and its control (the reference computed and accumulated in
bfloat16) and every broken timed path of ``bench/faults.py`` fail.  The
limit, 4e-3, rests on rounding: the port accumulates the taps in float32
and rounds each output once to bfloat16, which moves it by at most 2^-8 of
its own magnitude; accumulating in bfloat16 rounds at every tap and reads
several times that.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import faults, harness
from bench.reference import stencil as reference

ROOT = Path(__file__).resolve().parent.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "star13bf16-apply-512"
SHARES = ("copy16_share", "span_share")
ROUNDING = 2.0**-8  # round to nearest bfloat16: half of 2^-7 of a binade


def tiny(cell_name: str) -> dict:
    """The cell at a tiny size: a small grid, at most 4 blocks and calls."""
    cell = harness.load_cell(cell_name)
    mix = cell["mix"]
    cell["mix"] = dict(
        mix, grid=[16, 18, 20], blocks=min(mix["blocks"], 4),
        calls_per_request=min(mix["calls_per_request"], 4),
    )
    return cell


def test_the_configuration_and_its_cell():
    cell = harness.load_cell(CELL)
    config = cell["config"]
    assert config["dtype"] == "bfloat16" and config["reduced"] == []
    assert config["check"] == {"max_rel_err": 0.004,
                               "control_dtype": "bfloat16"}
    assert ROUNDING < config["check"]["max_rel_err"] < 2 * ROUNDING
    f32 = harness.load_cell("star13-apply-512")
    assert cell["mix"] == f32["mix"] and cell["chips"] == 1
    for key in ("operator", "boundary", "weight_rule"):
        assert config[key] == f32["config"][key], key
    per_layer = {m["name"] for m in cell["per_layer"]}
    assert set(SHARES) <= per_layer
    assert {"stencil_roofline", "host_ms_per_call"} <= per_layer


def test_the_shares_in_the_manifest():
    by_name = {m["name"]: m for m in MANIFEST["per_layer"]}
    for name in SHARES:
        m = by_name[name]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == (
            "%", "higher", "program_counter", "point_updates_per_s")
        assert m["layer"] == "stencil kernels and launch buffers"
        assert m["workloads"] == [CELL, "star13-apply-512",
                                  "star13-iter4-512", "box27-iter4-512"]


def test_a_sound_run_is_correct():
    result = harness.run_cell(tiny(CELL), 2**33 + 5, 0.15, False,
                              device="cpu")
    assert result["correct"], result["checks"]
    assert result["checks"]["calls_checked"]["value"] >= 1
    assert set(result["metrics"]) == {"point_updates_per_s",
                                      "request_p95_ms", "setup_s"}


def test_a_traced_run_reads_no_share_without_a_launch():
    """The plain path launches no kernel, so the shares read nothing and
    the line leaves them out."""
    result = harness.run_cell(tiny(CELL), 2**33 + 8, 0.15, True,
                              device="cpu")
    assert result["correct"], result["checks"]
    assert "host_ms_per_call" in result["metrics"]
    assert not set(SHARES) & set(result["metrics"])


@pytest.mark.parametrize("seed", [2**33 + 6, 2**40 + 17])
def test_the_control_fails(seed):
    """The plain reference computed and accumulated in bfloat16, put in
    the port's place."""
    result = harness.run_cell(tiny(CELL), seed, 0.15, False, device="cpu",
                              entry=harness.control_entry)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", faults.KINDS)
def test_a_broken_timed_path_fails(fault):
    result = harness.run_cell(tiny(CELL), 2**33 + 7, 0.15, False,
                              device="cpu", entry=faults.entry(fault))
    assert not result["correct"], (fault, result["checks"])


def _rel(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("seed", [1, 2, 3, 2**40 + 5])
def test_the_ports_bf16_apply_rounds_once_and_the_control_more(seed):
    """``stencil_pallas`` on the CPU (``sweep_apply_plain``: float32 taps,
    one rounding to bfloat16) stays within 2^-8 of the float64 reference's
    largest magnitude on a random grid with ``zero_drift`` weights; the
    reference computed in bfloat16 does not."""
    cell = tiny(CELL)
    taps, weights, (u,) = harness.inputs(cell["config"], cell["mix"], seed,
                                         "cpu")
    assert u.dtype == torch.bfloat16
    out = harness.port_entry(cell, taps, weights, "cpu")(u)
    assert out.dtype == torch.bfloat16 and out.shape == u.shape
    ref = reference.apply(u, taps, weights, 1, torch.float64, torch.float64)
    control = reference.apply(u, taps, weights, 1, torch.bfloat16)
    assert _rel(out, ref) <= ROUNDING
    assert _rel(control, ref) > ROUNDING


def _fake_totals(monkeypatch, warm):
    from repro_torch import obs

    monkeypatch.setattr(obs, "totals", lambda: {"warm": warm})


@pytest.mark.parametrize("name,want", [("copy16_share", 75.0),
                                       ("span_share", 25.0)])
def test_a_share_reads_its_counter_over_the_apply_launches(
        monkeypatch, name, want):
    _fake_totals(monkeypatch, {
        "stencil_call.n": 10, "launches.sweep_apply": 40,
        "launches.sweep_chain": 7, "apply_rows.copy16": 30,
        "apply_rows.span": 10})
    assert harness.reader(name)({}) == pytest.approx(want)


@pytest.mark.parametrize("name", SHARES)
@pytest.mark.parametrize("warm", [
    {"stencil_call.n": 10, "launches.sweep_apply": 40},  # no counters
    {"stencil_call.n": 10, "launches.sweep_apply": 0,  # no card launch
     "apply_rows.copy16": 0, "apply_rows.span": 0},
    {"stencil_call.n": 0, "launches.sweep_apply": 0,  # no warm call
     "apply_rows.copy16": 0, "apply_rows.span": 0},
    {},
])
def test_a_share_reads_nothing_without_counters_or_launches(
        monkeypatch, name, warm):
    _fake_totals(monkeypatch, warm)
    assert harness.reader(name)({}) is None


@pytest.mark.parametrize("name", SHARES)
def test_a_port_without_totals_reads_nothing(monkeypatch, name):
    from repro_torch import obs

    monkeypatch.delattr(obs, "totals")
    assert harness.reader(name)({}) is None
