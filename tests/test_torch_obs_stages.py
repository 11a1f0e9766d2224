"""The port's always-on stage timers and totals (``repro_torch.obs.stages``)
on the CPU.

* Stage spans: names, the call id every span of a call shares, parents
  and self time, for one planned apply, a planned T=4 chain split into
  launches, an explicit-tile fused chain, a periodic wrap and a two-shard
  call; a call inside an open call, and ``trace=``'s self-wrap, count once.
* Warm and cold: the first call of a signature is cold, a repeat warm.
* ``device_ops.*`` on each path, a trim counted only when it copies; a
  plain application reads the caller's grid (``launch_buffers.direct``):
  the host builds no launch buffer and trims nothing, and on the CPU the
  plain kernel's own padded copy counts a fill and a copy-in; every
  other path keeps its launch buffer.
* A traced and an untraced call are served by one memo entry.
* The stage timers allocate nothing that stays, and cost little.
* ``otherData.t0_unix_ns`` puts a span on ``torch.profiler``'s clock.
"""

import importlib.util
import sys
import time
import tracemalloc
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import ir as tir  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.cache_fitting import star_stencil  # noqa: E402
from repro_torch.kernels import stencil as tst  # noqa: E402
from repro_torch.obs import recorder  # noqa: E402
from repro_torch.plan import PlanCache, Planner  # noqa: E402
from repro_torch.plan import planner as planner_mod  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
O7 = star_stencil(3, 1)
W7 = [-1.5] + [0.25] * 6
OPS = ("fill", "copy_in", "wrap", "kernel", "trim")
CHILDREN = ("frontend", "decide", "launch_buffers", "sweep_launch", "trim")
# A plain application's stages: it reads the caller's grid, so its result
# needs no trim.
DIRECT = ("frontend", "decide", "launch_buffers", "sweep_launch")


@pytest.fixture(autouse=True)
def _no_leaked_recorder():
    assert obs.active() is None, "a previous test leaked a recorder"
    yield
    assert obs.active() is None, "this test leaked a recorder"


@pytest.fixture
def memory_planner(monkeypatch):
    """The frontends' default planner, memory-only and with an empty memo."""
    p = Planner(cache=PlanCache(persistent=False))
    monkeypatch.setattr(planner_mod, "_DEFAULT", p)
    return p


def _x(shape=(12, 16, 16), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _delta(before, after, part=None):
    """The totals' change between two snapshots (``part``: "warm" or
    "cold"), without the keys that did not move."""
    b = before if part is None else before[part]
    a = after if part is None else after[part]
    return {k: v - b.get(k, 0) for k, v in a.items()
            if not isinstance(v, dict) and v != b.get(k, 0)}


def _traced(fn):
    """``fn()`` under a recorder: its stage spans, in closing order, and
    the totals' change."""
    before = obs.totals()
    with obs.recording() as rec:
        fn()
    stages = [s for s in rec.spans if s.cat == "repro_torch.stage"]
    return stages, _delta(before, obs.totals())


def _ops(d):
    return {op: d.get(f"device_ops.{op}", 0) for op in OPS}


def _check_tree(stages, d):
    """One call: one root, every span of it under the call's id, parents
    named and enclosing their children, and the totals' self times those
    of the spans (their time less their children's)."""
    roots = [s for s in stages if s.name == "stencil_call"]
    assert len(roots) == 1
    root = roots[0]
    assert root.args == {"call": root.args["call"], "parent": None}
    assert {s.args["call"] for s in stages} == {root.args["call"]}
    eps = 1e-3  # µs: the spans' rounding
    by_parent = {}
    for s in stages:
        assert set(s.args) == {"call", "parent"}
        if s is root:
            continue
        parent = [p for p in stages if p.name == s.args["parent"]
                  and p.ts_us - eps <= s.ts_us
                  and s.ts_us + s.dur_us <= p.ts_us + p.dur_us + eps]
        assert parent, s.name
        by_parent.setdefault(id(parent[-1]), []).append(s)
    for name in {s.name for s in stages}:
        spans = [s for s in stages if s.name == name]
        assert d[f"{name}.n"] == len(spans), name
        own = sum(s.dur_us - sum(c.dur_us for c in by_parent.get(id(s), ()))
                  for s in spans)
        assert d[f"{name}.self_ns"] / 1e3 == pytest.approx(own, abs=0.01)
        assert d[f"{name}.ns"] / 1e3 == pytest.approx(
            sum(s.dur_us for s in spans), abs=0.01)
    return root


def test_planned_apply_is_one_call_of_six_stages(memory_planner):
    """The root and its stages; the launch reads the caller's grid, so
    the call has no trim, and its fill and copy-in are the plain kernel's
    padded copy."""
    x = _x()
    tst.stencil_pallas(x, O7, W7, device="cpu")
    stages, d = _traced(lambda: tst.stencil_pallas(x, O7, W7, device="cpu"))
    assert [s.name for s in stages] == [*DIRECT, "stencil_call"]
    root = _check_tree(stages, d)
    assert all(s.args["parent"] == "stencil_call" for s in stages
               if s is not root)
    assert d["calls"] == 1 and "cold_calls" not in d
    assert d["plan_memo_hit"] == 1
    assert _ops(d) == dict(fill=1, copy_in=1, wrap=0, kernel=1, trim=0)
    assert d["launch_buffers.direct"] == 1


def test_planned_chain_split_into_launches(memory_planner):
    x = _x((32, 32, 32))
    plan = next(p for p in memory_planner.candidates(
        k=8, shape=x.shape, offsets=O7, time_steps=4, vmem_budget=1 << 20)
        if p.fused_depth == 1)
    run = lambda: tst.stencil_iterate(x, O7, W7, 4, plan=plan,  # noqa: E731
                                      device="cpu")
    run()
    stages, d = _traced(run)
    assert [s.name for s in stages] == (
        ["frontend", "decide"] + ["launch_buffers", "sweep_launch"] * 4
        + ["stencil_call"])
    _check_tree(stages, d)
    # Each launch reads the last one's output as it is: four kernels, each
    # with the plain version's padded copy, and no trim, whether or not the
    # tile divides the grid.
    assert _ops(d) == dict(fill=4, copy_in=4, wrap=0, kernel=4, trim=0)
    assert d["launch_buffers.direct"] == 4


@pytest.mark.parametrize("shape,tile,p", [
    ((12, 13, 14), (4, 8, 8), 1), ((37, 41, 45), (8, 16, 32), 1),
    ((12, 13, 14), (5, 4, 8), 2)])
def test_ragged_apply_builds_no_buffer_and_trims_nothing(shape, tile, p,
                                                        monkeypatch):
    """A tile that does not divide the grid: the kernel's output is the
    grid's shape already, so the host builds no launch buffer and trims
    nothing; the fills and copies in are the plain kernel's padded copy
    of each RHS."""
    monkeypatch.setattr(tst, "embed_inputs", _no_embed)
    us = [_x(shape, seed=a) for a in range(p)]
    stages, d = _traced(lambda: tst.multi_stencil_pallas(
        us, [O7] * p, [W7] * p, tile=tile, sweep_axis=0, device="cpu"))
    assert [s.name for s in stages] == [*DIRECT, "stencil_call"]
    _check_tree(stages, d)
    assert _ops(d) == dict(fill=p, copy_in=p, wrap=0, kernel=1, trim=0)
    assert d["launch_buffers.direct"] == 1


def _no_embed(*args, **kwargs):
    raise AssertionError("a plain application built a launch buffer")


def _quantized_chain():
    prog = tir.chain_program([(O7, W7)] * 2, 3, boundary="reflect",
                             quants=[(0.05, 2), None])
    return tst.multi_stencil_pallas([_x() * np.float32(0.1)], None, None,
                                    program=prog, tile=(4, 8, 8),
                                    device="cpu")


@pytest.mark.parametrize("path,direct", [
    ("apply", 1),
    ("chain", 0),
    ("periodic", 0),
    ("quantized", 0),
    ("sharded", 0),
])
def test_direct_counter_counts_launches_on_the_callers_grid(path, direct,
                                                           monkeypatch):
    """``launch_buffers.direct``: one a plain application, none where the
    launch keeps its buffer (a fused chain, periodic wrap, a quantized
    stage, column shards).  Only the plain application builds no launch
    buffer on the host; each path fills one buffer a kernel (the plain
    application's is its plain kernel's padded copy)."""
    from repro_torch.parallel import shard_columns

    embeds = []
    embed = tst.embed_inputs
    for mod in (tst, shard_columns):
        monkeypatch.setattr(
            mod, "embed_inputs",
            lambda *a, **k: embeds.append(1) or embed(*a, **k))
    x = _x((16, 16, 16))
    runs = {
        "apply": lambda: tst.stencil_pallas(x, O7, W7, tile=(4, 8, 8),
                                            device="cpu"),
        "chain": lambda: tst.stencil_iterate(x, O7, W7, 2, tile=(4, 8, 8),
                                             device="cpu"),
        "periodic": lambda: tst.multi_stencil_pallas(
            [x], None, None, tile=(4, 8, 8), device="cpu",
            program=tir.chain_program([(O7, W7)], 3, boundary="periodic")),
        "quantized": _quantized_chain,
        "sharded": lambda: tst.stencil_pallas(
            x, O7, W7, tile=(4, 8, 16), sweep_axis=0, num_shards=2,
            shard_axis=1, device="cpu"),
    }
    before = obs.totals()
    runs[path]()
    d = _delta(before, obs.totals())
    assert d.get("launch_buffers.direct", 0) == direct
    assert d["device_ops.kernel"] == (2 if path == "sharded" else 1)
    assert d["device_ops.fill"] == d["device_ops.kernel"]
    assert (not embeds) == bool(direct)


def test_explicit_tile_fused_chain_and_a_copying_trim():
    x = _x((12, 13, 14))
    run = lambda: tst.stencil_iterate(x, O7, W7, 3,  # noqa: E731
                                      tile=(4, 8, 8), device="cpu")
    stages, d = _traced(run)
    assert [s.name for s in stages] == [*CHILDREN, "stencil_call"]
    _check_tree(stages, d)
    # (12, 13, 14) runs padded to (12, 16, 16): the trim copies.
    assert _ops(d) == dict(fill=1, copy_in=1, wrap=0, kernel=1, trim=1)
    # A tile dividing the grid trims nothing.
    stages, d = _traced(lambda: tst.stencil_iterate(
        _x((12, 16, 16)), O7, W7, 3, tile=(4, 8, 8), device="cpu"))
    assert _ops(d) == dict(fill=1, copy_in=1, wrap=0, kernel=1, trim=0)


def test_periodic_wrap_counts_each_band():
    prog = tir.chain_program([(O7, W7)] * 2, 3, boundary="periodic")
    stages, d = _traced(lambda: tst.multi_stencil_pallas(
        [_x((12, 16, 16))], None, None, program=prog, tile=(4, 8, 8),
        device="cpu"))
    _check_tree(stages, d)
    # Radius 2 over the fused pair on each of 3 axes: a low and a high
    # band each, each a gather and a copy.
    assert _ops(d) == dict(fill=1, copy_in=1, wrap=12, kernel=1, trim=0)


def test_two_shard_call():
    x = _x((16, 16, 16))
    stages, d = _traced(lambda: tst.stencil_pallas(
        x, O7, W7, tile=(4, 8, 16), sweep_axis=0, num_shards=2,
        shard_axis=1, device="cpu"))
    assert [s.name for s in stages] == [
        "frontend", "decide", "launch_buffers", "sweep_launch",
        "sweep_launch", "trim", "stencil_call"]
    _check_tree(stages, d)
    # Each shard: a fill and a copy-in; one halo row each way between
    # them; a kernel each; the gather copies each shard back.
    assert _ops(d) == dict(fill=2, copy_in=2, wrap=2, kernel=2, trim=2)


def test_a_call_inside_an_open_call_and_the_trace_wrap_count_once(
        tmp_path):
    x = _x()
    before = obs.totals()
    with obs.call():
        tst.stencil_pallas(x, O7, W7, tile=(4, 8, 8), device="cpu")
        tst.stencil_pallas(x, O7, W7, tile=(4, 8, 8), device="cpu")
    d = _delta(before, obs.totals())
    assert d["calls"] == d["stencil_call.n"] == 1
    assert d["frontend.n"] == d["sweep_launch.n"] == 2
    before = obs.totals()
    tst.stencil_pallas(x, O7, W7, tile=(4, 8, 8), device="cpu",
                       trace=str(tmp_path / "t.json"))
    assert _delta(before, obs.totals())["calls"] == 1


def test_an_exception_closes_the_calls_stages():
    before = obs.totals()
    with pytest.raises(ValueError):
        tst.stencil_pallas(_x(), O7, W7[:3], tile=(4, 8, 8), device="cpu")
    d = _delta(before, obs.totals())
    assert d["calls"] == d["stencil_call.n"] == 1
    stages, d = _traced(lambda: tst.stencil_pallas(
        _x(), O7, W7, tile=(4, 8, 8), device="cpu"))
    _check_tree(stages, d)


def test_first_call_is_cold_and_a_repeat_warm(memory_planner):
    """The repeat of a planned apply is served by the call memo, which
    goes from the key to the bound launch without asking the planner."""
    x = torch.from_numpy(_x((12, 13, 16)))
    before = obs.totals()
    tst.stencil_pallas(x, O7, W7, device="cpu")
    mid = obs.totals()
    cold = _delta(before, mid, "cold")
    assert cold["calls"] == cold["cold_calls"] == 1
    assert cold["plan_memo_miss"] == cold["call_memo.miss"] == 1
    assert not _delta(before, mid, "warm")
    tst.stencil_pallas(x, O7, W7, device="cpu")
    after = obs.totals()
    warm = _delta(mid, after, "warm")
    assert warm["calls"] == warm["call_memo.hit"] == 1
    assert "plan_memo_hit" not in warm and "plan_memo_miss" not in warm
    assert warm["frontend.n"] == warm["decide.n"] == 1
    assert not _delta(mid, after, "cold")
    flat = _delta(mid, after)
    assert flat["calls"] == 1 and "cold_calls" not in flat


def test_traced_and_untraced_calls_share_one_memo_entry(memory_planner,
                                                        tmp_path):
    """Recording no longer changes the path: a traced call is served by
    the memo entry an untraced call made, and the other way round.  (The
    call memo, which a traced call bypasses, is emptied with the
    planner's.)"""
    x = _x()
    for first, second in ((None, tmp_path / "a.json"),
                          (tmp_path / "b.json", None)):
        memory_planner._by_call.clear()
        tst._CALL_MEMO.clear()
        before = obs.totals()
        tst.stencil_pallas(x, O7, W7, device="cpu", trace=first and
                           str(first))
        (entry,) = memory_planner._by_call.values()
        tst.stencil_pallas(x, O7, W7, device="cpu", trace=second and
                           str(second))
        d = _delta(before, obs.totals())
        assert d["plan_memo_miss"] == d["plan_memo_hit"] == 1
        (again,) = memory_planner._by_call.values()
        assert again is entry
    doc = obs.load_trace(str(tmp_path / "a.json"))
    (plan,) = [e for e in doc["traceEvents"]
               if e["ph"] == "X" and e["name"] == "plan"]
    assert plan["args"]["memo"] == "hit"
    assert plan["args"]["tile"] == list(entry.tile)
    assert plan["args"]["key"] == entry.request.cache_key()


def _hot():
    """The stage timers of one call as the blocks cell runs it: the root,
    five stages and the device-operation counts."""
    with obs.call():
        for s in _STAGES:
            s.begin()
            s.end()
        for c in _COUNTS:
            obs.count(c)


_STAGES = [obs.stage(n) for n in CHILDREN]
_COUNTS = [obs.counter(f"device_ops.{op}") for op in ("fill", "copy_in",
                                                      "kernel")] + [
    obs.counter("launch_table_hit"), obs.counter("plan_memo_hit")]


def test_stage_timers_allocate_nothing_that_stays():
    assert not obs.enabled()
    obs_dir = Path(recorder.__file__).parent
    tracemalloc.start(1)
    try:
        # Warm up under tracing, every total past the small-int cache: the
        # ints the totals hold are then traced in both snapshots, and a
        # bump only replaces one.
        for _ in range(300):
            _hot()
        before = tracemalloc.take_snapshot()
        for _ in range(512):
            _hot()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [
        d for d in after.compare_to(before, "lineno")
        if Path(d.traceback[0].filename).parent == obs_dir
        and (d.count_diff > 0 or d.size_diff > 0)
    ]
    assert not grown, grown
    import gc

    gc.collect()
    before = sys.getallocatedblocks()
    for _ in range(512):
        _hot()
    gc.collect()
    after = sys.getallocatedblocks()
    assert after - before <= 2, (
        f"the stage timers kept {after - before} blocks over 512 calls")


def test_stage_timers_cost_little():
    """A loose bound on the thread's CPU time a call, the best of many
    short rounds, so that it holds beside other test workers; the timers'
    own cost on the card's host is measured by
    ``scripts/obs_off_cost.py``."""
    for _ in range(200):
        _hot()
    best = float("inf")
    for _ in range(30):
        t0 = time.thread_time_ns()
        for _ in range(200):
            _hot()
        best = min(best, (time.thread_time_ns() - t0) / 200)
    assert best < 20e3, f"{best / 1e3:.2f} µs a call"


def test_trace_clock_is_the_profilers():
    """A torch op run inside a recorded span starts, on ``torch.profiler``'s
    clock, inside the span shifted by ``otherData.t0_unix_ns``."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.rand(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.recording(profiler_bridge=False) as rec:
            with obs.span("outer"):
                time.sleep(0.002)
                torch.mm(x, x)
                time.sleep(0.002)
    doc = rec.to_trace_events()
    t0 = doc["otherData"]["t0_unix_ns"]
    (span,) = [e for e in doc["traceEvents"] if e.get("name") == "outer"]
    lo = t0 + round(span["ts"] * 1e3)
    hi = lo + round(span["dur"] * 1e3)
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mm"]
    assert starts
    for s in starts:
        assert lo <= s <= hi, (lo, s, hi)


def test_innermost_labels_each_moment_by_its_innermost_stage():
    spec = importlib.util.spec_from_file_location(
        "idle_by_stage", ROOT / "scripts" / "idle_by_stage.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    spans = [(0, 100, "call"), (10, 30, "frontend"), (30, 40, "decide"),
             (50, 90, "buffers"), (60, 70, "inner"), (200, 210, "call")]
    assert mod.innermost(spans) == [
        (0, 10, "call"), (10, 30, "frontend"), (30, 40, "decide"),
        (40, 50, "call"), (50, 60, "buffers"), (60, 70, "inner"),
        (70, 90, "buffers"), (90, 100, "call"), (200, 210, "call")]
