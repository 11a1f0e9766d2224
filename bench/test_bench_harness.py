"""CPU checks of the harness: the frozen roofline, the plain reference, the
imports, and a run at a tiny size with the port's plain versions, its
control and each broken timed path.  One test, marked ``cuda``, runs a
cell on the card and skips without one."""

from __future__ import annotations

import ast
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import faults, harness, roofline
from bench.reference import stencil as reference

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"


def tiny(cell_name: str) -> dict:
    """The cell at a tiny size: a small grid, at most 4 blocks and calls."""
    cell = harness.load_cell(cell_name)
    mix = cell["mix"]
    cell["mix"] = dict(
        mix, grid=[16, 18, 20], blocks=min(mix["blocks"], 4),
        calls_per_request=min(mix["calls_per_request"], 4),
    )
    return cell


CELLS = ["star13-apply-512", "box27-iter4-512", "star13-blocks-128"]


def test_roofline_against_hand_numbers():
    star = roofline.work((512,) * 3, 13, 1, 4)
    assert star["bound_by"] == "bytes"
    assert star["bytes"] == 2 * 512**3 * 4
    assert star["least_s"] * 1e3 == pytest.approx(0.3205, abs=5e-5)
    box = roofline.work((512,) * 3, 27, 4, 4)
    assert box["bound_by"] == "operations"
    assert box["flops"] == 2 * 27 * 4 * 512**3
    assert box["least_s"] * 1e3 == pytest.approx(0.433, abs=5e-4)
    star4 = roofline.work((512,) * 3, 13, 4, 4)
    assert star4["bound_by"] == "bytes"
    assert star4["least_s"] == star["least_s"]


PAD_MODES = {"zero": "constant", "dirichlet": "constant", "neumann": "edge",
             "reflect": "reflect", "periodic": "wrap"}


def naive(u: np.ndarray, taps, weights, steps: int, boundary="zero",
          value=0.0) -> np.ndarray:
    """Point by point, reading past the grid through numpy's own pad."""
    x = u.astype(np.float64)
    r = max(max(abs(c) for c in o) for o in taps)
    for _ in range(steps):
        kw = {"constant_values": 0.0 if boundary == "zero" else value} \
            if PAD_MODES[boundary] == "constant" else {}
        xp = np.pad(x, r, mode=PAD_MODES[boundary], **kw)
        y = np.zeros_like(x)
        for p in itertools.product(*map(range, x.shape)):
            y[p] = sum(w * xp[tuple(a + b + r for a, b in zip(p, o))]
                       for o, w in zip(taps, weights))
        x = y
    return x


@pytest.mark.parametrize("boundary", list(PAD_MODES))
@pytest.mark.parametrize("kind,radius", [("star", 2), ("box", 1)])
def test_reference_against_a_naive_loop(kind, radius, boundary):
    taps = reference.offsets(kind, radius)
    assert len(taps) == {"star": 13, "box": 27}[kind]
    rng = np.random.default_rng(7)
    u = rng.random((5, 6, 7))
    w = rng.random(len(taps))
    got = reference.apply(torch.from_numpy(u), taps, w, steps=2,
                          boundary=boundary, value=0.25)
    np.testing.assert_allclose(
        got.numpy(), naive(u, taps, w, 2, boundary, 0.25),
        rtol=1e-13, atol=1e-15)


def test_reference_stores_float8_for_the_control_of_a_bfloat16_config():
    """A float8 control (one step below bfloat16) stores each step in
    float8 and computes between in float32: far off the float64 result,
    and equal to rounding a float32 step through float8 by hand."""
    taps = reference.offsets("star", 2)
    rng = np.random.default_rng(9)
    u = torch.from_numpy(rng.random((8, 9, 10))).to(torch.bfloat16)
    w = (rng.random(len(taps)) / 13).tolist()
    f8 = torch.float8_e4m3fn
    got = reference.apply(u, taps, w, 2, f8, torch.float32)
    x = u.to(f8).float()
    for _ in range(2):
        x = reference.apply(x, taps, w, 1, torch.float32).to(f8).float()
    torch.testing.assert_close(got, x, rtol=0, atol=0)
    exact = reference.apply(u, taps, w, 2, torch.float64, torch.float64)
    rel = float((got.double() - exact).abs().max() / exact.abs().max())
    assert 1e-3 < rel < 0.2, rel


@pytest.mark.parametrize("boundary", ["zero", "dirichlet", "neumann",
                                      "reflect", "periodic"])
def test_reference_boundaries_mean_what_the_port_means(boundary):
    """Each boundary the reference takes reads past the grid as the port's
    own plain version defines it, so that a configuration naming it holds
    the port to the port's semantics."""
    from repro_torch.kernels.ref import stencil_ref

    taps = reference.offsets("star", 2)
    rng = np.random.default_rng(8)
    u = torch.from_numpy(rng.random((6, 7, 8)))
    w = rng.random(len(taps)).tolist()
    got = reference.apply(u, taps, w, boundary=boundary, value=0.5)
    want = stencil_ref(u, np.asarray(taps), w, boundary=boundary, value=0.5)
    torch.testing.assert_close(got, want, rtol=1e-13, atol=1e-14)


@pytest.mark.parametrize("kind,radius", [("star", 2), ("box", 1),
                                         ("star", 1)])
def test_zero_drift_weights(kind, radius):
    """Non-negative, summing to 1, no first moment on any axis, and unequal
    on opposite taps wherever the taps leave room (a 7-point star leaves
    none)."""
    taps = reference.offsets(kind, radius)
    for seed in (1, 2**40 + 9):
        w = np.array(harness.zero_drift_weights(
            taps, np.random.default_rng(seed)))
        assert w.min() > 0 and w.sum() == pytest.approx(1.0, abs=1e-6)
        assert np.abs(np.array(taps).T @ w).max() < 1e-7
        mirror = np.array([w[taps.index(tuple(-v for v in o))]
                           for o in taps])
        odd = np.abs(w - mirror).max()
        if (kind, radius) == ("star", 1):
            assert odd == 0
        else:
            assert odd > 0.1 * w.mean(), odd


def test_reference_taps_are_in_the_ports_order():
    """The taps handed to the port come in the order of its own
    ``star_stencil`` and ``box_stencil``, the order its compiled shapes
    expect."""
    from repro_torch.core.cache_fitting import box_stencil, star_stencil

    assert reference.offsets("star", 2) == [
        tuple(o) for o in star_stencil(3, 2).tolist()]
    assert reference.offsets("box", 1) == [
        tuple(o) for o in box_stencil(3, 1).tolist()]


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_in_the_benchmark_and_no_port_in_its_reference():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for path in files:
        found = _top_level_imports(path)
        assert not found & {"jax", "jaxlib", "flax", "repro"}, (path, found)
        if "reference" in path.relative_to(BENCH).parts:
            assert "repro_torch" not in found, path


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_sound_run_is_correct(cell_name):
    result = harness.run_cell(tiny(cell_name), 2**33 + 5, 0.15, False,
                              device="cpu")
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    cell = tiny(cell_name)
    off_card = {"peak_mem_gb"}  # nothing to read without a card
    assert set(result["metrics"]) == {
        m["name"] for m in cell["end_to_end"]} - off_card
    lines = harness.check_lines(result)
    assert lines[0].startswith("check max_rel_err ")
    assert lines[1].startswith("check fresh_max_rel_err ")
    assert result["checks"]["calls_checked"]["value"] >= 1


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_fails(cell_name):
    """The plain reference computed in bfloat16, put in the port's place."""
    result = harness.run_cell(tiny(cell_name), 2**33 + 6, 0.15, False,
                              device="cpu", entry=harness.control_entry)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", faults.KINDS)
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_broken_timed_path_fails(cell_name, fault):
    result = harness.run_cell(tiny(cell_name), 2**33 + 7, 0.15, False,
                              device="cpu", entry=faults.entry(fault))
    assert not result["correct"], (fault, result["checks"])


def test_jax_and_the_jax_package_are_named_by_whole_top_level_names():
    names = ["repro_torch.kernels.stencil", "numpy", "jax.numpy",
             "jaxlib.xla_client", "repro.kernels", "reprox", "flax"]
    assert harness.forbidden_modules(names) == [
        "flax", "jax", "jaxlib", "repro"]
    assert harness.forbidden_modules(["repro_torch", "bench.harness"]) == []


def test_inputs_repeat_for_a_seed_past_32_bits():
    cell = tiny("star13-blocks-128")
    a = harness.inputs(cell["config"], cell["mix"], 2**40 + 1, "cpu")
    b = harness.inputs(cell["config"], cell["mix"], 2**40 + 1, "cpu")
    c = harness.inputs(cell["config"], cell["mix"], 2**40 + 2, "cpu")
    assert a[1] == b[1] and a[1] != c[1]
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
    assert all(w >= 0 for w in a[1])
    assert sum(a[1]) == pytest.approx(1.0, abs=1e-6)
    assert cell["config"]["weight_rule"] == "zero_drift"
    f1 = list(harness.fresh_grids(cell["config"], cell["mix"], 2**40 + 1,
                                  "cpu"))
    f2 = list(harness.fresh_grids(cell["config"], cell["mix"], 2**40 + 1,
                                  "cpu"))
    assert len(f1) == cell["mix"]["fresh_calls"]
    assert all(torch.equal(x, y) for x, y in zip(f1, f2))
    assert not torch.equal(f1[0], a[2][0])


@pytest.mark.parametrize("fault", ["unchanged", "stale", "skip_half",
                                   "mirrored"])
def test_calls_on_fresh_grids_catch_what_a_smoothed_window_hides(fault):
    """However smooth the window's field has become, the calls on fresh
    grids after it read each of these faults far over the limit."""
    cell = tiny("star13-apply-512")
    result = harness.run_cell(cell, 2**35 + 1, 0.15, False, device="cpu",
                              entry=faults.entry(fault))
    fresh = result["checks"]["fresh_max_rel_err"]
    assert fresh["value"] > 10 * fresh["limit"], (fault, fresh)


def test_without_a_card_it_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "star13-apply-512",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode not in (0, None)
    assert proc.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "star13-blocks-128",
         "--seed", str(2**31 + 11), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=1200,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert "launches_per_step.blocks" in result["metrics"]


def test_trace_summary_splits_idle_time_by_host_state():
    """Busy time is the union of the device intervals; each idle gap is
    split among the port calls and ``synchronize()`` calls over it, the
    rest going to the loop's own bookkeeping."""
    from bench import trace

    events = [("void k(int)", 100, 200), ("k", 150, 300), ("c", 400, 500)]
    host = [(50, 120, "port_call"), (300, 380, "synchronize"),
            (390, 410, "port_call")]
    s = trace.summarize(events, 0, 600, host)
    assert s["aligned"] and s["n_ops"] == 3
    assert s["busy_s"] == pytest.approx(300e-9)
    assert s["ops"] == pytest.approx({"k": 250e-9, "c": 100e-9})
    assert s["idle"] == pytest.approx(
        {"port_call": 60e-9, "synchronize": 80e-9, "harness": 160e-9})
    out = trace.breakdown(s)
    assert out["device_ops"][0] == ["k", pytest.approx(250e-9)]
    assert len(out["idle_gaps"]) <= 10


def test_trace_summary_leaves_out_the_paused_spans():
    """A device operation inside a pause (the check's copy to the host) is
    not counted, nor is idle time over a pause."""
    from bench import trace

    events = [("k", 100, 200), ("Memcpy DtoH (Device -> Pageable)", 320, 380),
              ("k", 450, 500)]
    host = [(50, 120, "port_call"), (400, 460, "port_call")]
    s = trace.summarize(events, 0, 600, host, holes=[(300, 400)])
    assert s["n_ops"] == 2 and s["busy_s"] == pytest.approx(150e-9)
    assert sum(s["idle"].values()) == pytest.approx(350e-9)
    # a port kernel that a hole's edge overlaps, on clocks a little off,
    # still counts
    s = trace.summarize(events, 0, 600, host, holes=[(190, 400)])
    assert s["n_ops"] == 2 and s["busy_s"] == pytest.approx(150e-9)
