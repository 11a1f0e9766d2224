"""CPU checks of ``pair_share`` (``bench/metrics/pair_share.py``), the
share of the port's warm apply launches whose bf16 kernel computed two
neighbouring outputs a thread (counter ``apply_rows.pair``).

The reader divides the counter by the warm apply launches on the card.  A
port without the totals, without the counter, without a warm call or
without an apply launch on the card (the CPU's plain path launches none)
reads nothing and raises nothing.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from bench import harness

ROOT = Path(__file__).resolve().parent.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_manifest_entry():
    by_name = {m["name"]: m for m in MANIFEST["per_layer"]}
    assert by_name["pair_share"] == {
        "name": "pair_share", "unit": "%", "better": "higher",
        "source": "program_counter",
        "layer": "stencil kernels and launch buffers",
        "moves": "point_updates_per_s",
        "workloads": ["star13bf16-apply-512"]}
    assert MANIFEST["per_layer"][-1]["name"] == "pair_share"
    cell = harness.load_cell("star13bf16-apply-512")
    assert "pair_share" in {m["name"] for m in cell["per_layer"]}
    for other in ("star13-apply-512", "star13-iter4-512", "box27-iter4-512",
                  "star13-blocks-128"):
        assert "pair_share" not in {
            m["name"] for m in harness.load_cell(other)["per_layer"]}


def _fake_totals(monkeypatch, warm):
    from repro_torch import obs

    monkeypatch.setattr(obs, "totals", lambda: {"warm": warm})


@pytest.mark.parametrize("pairs,want", [(40, 100.0), (10, 25.0), (0, 0.0)])
def test_the_share_reads_the_counter_over_the_apply_launches(
        monkeypatch, pairs, want):
    _fake_totals(monkeypatch, {
        "stencil_call.n": 10, "launches.sweep_apply": 40,
        "launches.sweep_chain": 7, "apply_rows.copy16": 40,
        "apply_rows.span": 40, "apply_rows.pair": pairs})
    assert harness.reader("pair_share")({}) == pytest.approx(want)


@pytest.mark.parametrize("warm", [
    {"stencil_call.n": 10, "launches.sweep_apply": 40,  # no pair counter
     "apply_rows.copy16": 40, "apply_rows.span": 40},
    {"stencil_call.n": 10, "launches.sweep_apply": 0,  # no card launch
     "apply_rows.pair": 0},
    {"stencil_call.n": 0, "launches.sweep_apply": 0,  # no warm call
     "apply_rows.pair": 0},
    {},
], ids=["no_counter", "no_launch", "no_warm_call", "empty"])
def test_the_share_reads_nothing_without_counter_or_launches(monkeypatch,
                                                             warm):
    _fake_totals(monkeypatch, warm)
    assert harness.reader("pair_share")({}) is None


def test_a_port_without_totals_reads_nothing(monkeypatch):
    from repro_torch import obs

    monkeypatch.delattr(obs, "totals")
    assert harness.reader("pair_share")({}) is None


def test_the_cpu_plain_path_reads_nothing():
    """The port's own totals after plain (CPU) calls hold the counter but
    no apply launch on the card: no reading."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core.cache_fitting import star_stencil
    from repro_torch.kernels import stencil as st

    obs.reset_totals()
    x = torch.rand((16, 18, 20)).to(torch.bfloat16)
    o = star_stencil(3, 2)
    for _ in range(3):
        st.stencil_pallas(x, o, np.full(len(o), 1 / 13), device="cpu")
    warm = obs.totals()["warm"]
    assert warm["apply_rows.pair"] == warm["launches.sweep_apply"] == 0
    assert harness.reader("pair_share")({}) is None
