"""The port's telemetry (``repro_torch.obs``) on the CPU.

* The cases of ``tests/test_obs.py`` on the port: recorder spans, counters
  and events; nesting; the trace's shape; ``validate_trace`` rejects
  garbage; ``REPRO_TORCH_TRACE`` activation in a subprocess; the disabled
  path allocates nothing (``tracemalloc``); the plan span and the plan
  cache's counters; the ``measure`` span and its counter; cache and tuned
  DB degrade; a traced, tuned run reconciles, unsharded and over 4
  shards.  Left out: the JAX package's interpret-fallback case (the port
  has no fallback, so no such counter).
* Parity: the same program traced in JAX (interpret mode, as
  ``test_obs.py`` runs it) and in the port (``device="cpu"``) gives the
  same sequence of ``kernel_launch`` spans — tile, sweep axis, fused
  depth, steps, window kind, stage dtypes — and the same ``launches``
  counter; at a plan handed to both, the same modelled bytes and flops.
* The port's trace files pass the JAX package's
  ``repro.obs.trace_event.validate_trace``.
"""

import json
import os
import subprocess
import sys
import tracemalloc
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import ir as jir  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro import plan as jplan  # noqa: E402
from repro.kernels import stencil as jst  # noqa: E402
from repro.obs.trace_event import validate_trace as j_validate  # noqa: E402
from repro_torch import ir as tir  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.cache_fitting import star_stencil  # noqa: E402
from repro_torch.core.tiling import (  # noqa: E402
    frontier_smem_bytes,
    halo_from_offsets,
    sweep_smem_bytes,
)
from repro_torch.kernels import stencil as tst  # noqa: E402
from repro_torch.obs import recorder  # noqa: E402
from repro_torch.obs.report import main as report_main  # noqa: E402
from repro_torch.obs.report import reconcile, render, summarize  # noqa: E402
from repro_torch.obs.trace_event import validate_trace  # noqa: E402
from repro_torch.plan import (  # noqa: E402
    AutoTuner,
    PlanCache,
    Planner,
    TunedPlanDB,
    planner as planner_mod,
)

ROOT = Path(__file__).resolve().parent.parent

O13 = star_stencil(3, 2)
W13 = np.linspace(-0.4, 0.5, 13).tolist()
O7 = star_stencil(3, 1)
W7 = [-1.5] + [0.25] * 6


@pytest.fixture(autouse=True)
def _no_leaked_recorder():
    """Every test starts and ends with recording disabled, in both
    packages."""
    assert obs.active() is None, "a previous test leaked a recorder"
    assert jobs.active() is None
    yield
    assert obs.active() is None, "this test leaked a recorder"
    assert jobs.active() is None


@pytest.fixture
def memory_planner(monkeypatch):
    """The frontends' default planner, memory-only: nothing lands in ~."""
    p = Planner(cache=PlanCache(persistent=False))
    monkeypatch.setattr(planner_mod, "_DEFAULT", p)
    return p


def _data(shape, seed=0, n=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _load(path):
    with open(path) as fh:
        return json.load(fh)


# -- the recorder ---------------------------------------------------------------


def test_recorder_spans_counters_events(tmp_path):
    path = str(tmp_path / "t.json")
    with obs.recording(path) as rec:
        assert obs.enabled() and obs.active() is rec
        with obs.span("plan", key="abc") as sp:
            sp.set(depth=3)
        obs.add("launches")
        obs.add("modeled_bytes", 1234)
        obs.add("modeled_bytes", 66)
        obs.event("plan_cache_degrade", dir="/nowhere")
    assert not obs.enabled()
    assert [s.name for s in rec.spans] == ["plan"]
    assert rec.spans[0].args == {"key": "abc", "depth": 3}
    assert rec.spans[0].dur_us >= 0.0
    assert rec.counters == {"launches": 1, "modeled_bytes": 1300}
    assert rec.events[0]["name"] == "plan_cache_degrade"
    # recording(path) wrote a valid trace on exit
    doc = validate_trace(_load(path))
    assert doc["otherData"]["counters"]["modeled_bytes"] == 1300
    assert doc["otherData"]["producer"] == "repro_torch.obs"


def test_recording_nests():
    with obs.recording() as outer:
        obs.add("n")
        with obs.recording() as inner:
            obs.add("n", 5)  # innermost recorder shadows
        assert obs.active() is outer
        obs.add("n")
    assert outer.counters == {"n": 2}
    assert inner.counters == {"n": 5}


def test_trace_event_shape():
    with obs.recording() as rec:
        with obs.span("kernel_launch", modeled_bytes=10):
            pass
        obs.add("launches")
        obs.event("mark")
    doc = rec.to_trace_events()
    validate_trace(doc)
    phs = {ev["ph"] for ev in doc["traceEvents"]}
    assert {"M", "X", "C", "i"} <= phs
    x = [e for e in doc["traceEvents"] if e["ph"] == "X"][0]
    assert x["name"] == "kernel_launch" and x["args"]["modeled_bytes"] == 10


def test_validate_trace_rejects_garbage():
    with pytest.raises(ValueError, match="traceEvents"):
        validate_trace({"events": []})
    with pytest.raises(ValueError, match="must be a list"):
        validate_trace({"traceEvents": {}})
    with pytest.raises(ValueError, match="unknown ph"):
        validate_trace({"traceEvents": [{"ph": "Z", "name": "x",
                                         "pid": 0, "tid": 0}]})
    with pytest.raises(ValueError, match="missing 'tid'"):
        validate_trace({"traceEvents": [{"ph": "i", "name": "x",
                                         "pid": 0}]})
    with pytest.raises(ValueError, match="non-numeric"):
        validate_trace({"traceEvents": [
            {"ph": "X", "name": "x", "pid": 0, "tid": 0, "ts": "now"}
        ]})


def _run_child(code, env_extra, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("REPRO_TRACE", "REPRO_TORCH_TRACE")}
    env.update(env_extra)
    env["PYTHONPATH"] = (
        str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    ).rstrip(os.pathsep)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=tmp_path, timeout=120)


def test_env_activation_writes_trace_at_exit(tmp_path):
    trace = tmp_path / "env.json"
    code = (
        "from repro_torch import obs\n"
        "assert obs.enabled()\n"
        "obs.add('launches', 2)\n"
        "with obs.span('plan', key='k'):\n"
        "    pass\n"
    )
    _run_child(code, {"REPRO_TORCH_TRACE": str(trace)}, tmp_path)
    doc = validate_trace(_load(trace))
    assert doc["otherData"]["counters"]["launches"] == 2
    assert any(e["ph"] == "X" and e["name"] == "plan"
               for e in doc["traceEvents"])


def test_env_variable_is_the_ports_own(tmp_path):
    """``REPRO_TRACE`` (the JAX package's) does not turn the port's
    recorder on, so a process importing both never flushes two traces to
    one path."""
    trace = tmp_path / "jax-only.json"
    code = (
        "from repro_torch import obs\n"
        "assert not obs.enabled()\n"
        "obs.add('launches')\n"
    )
    _run_child(code, {"REPRO_TRACE": str(trace)}, tmp_path)
    assert not trace.exists()


# -- the disabled path: one predicate check, no allocation ---------------------


def test_disabled_path_allocates_nothing():
    assert not obs.enabled()
    assert obs.span("a") is obs.span("b") is obs.NULL_SPAN
    assert obs.NULL_SPAN.set(x=1) is obs.NULL_SPAN

    def hot():
        # The exact shape of every instrumented hot path: a predicate
        # check, a bare span, a counter bump.
        if obs.enabled():
            raise AssertionError("recording must be off")
        with obs.span("kernel_launch"):
            pass
        obs.add("launches")

    for _ in range(64):  # warm caches/freelists
        hot()
    obs_dir = Path(recorder.__file__).parent
    tracemalloc.start(1)
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(512):
            hot()
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
        hot()
    gc.collect()
    after = sys.getallocatedblocks()
    assert after - before <= 2, (
        f"no-op obs path leaked {after - before} blocks over 512 calls"
    )


def test_plan_cache_warm_hit_stays_fast_with_obs_disabled():
    import time

    planner = Planner(cache=PlanCache(persistent=False))
    kw = dict(shape=(32, 64, 128), offsets=O7, vmem_budget=64 * 1024)
    plan = planner.plan(**kw)
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = planner.plan(**kw)
        warm.append((time.perf_counter() - t0) * 1e3)
        assert again == plan
    assert min(warm) < 1.0, f"warm hit took {min(warm):.3f} ms"


# -- layer instrumentation -------------------------------------------------------


def test_plan_span_and_cache_counters():
    planner = Planner(cache=PlanCache(persistent=False))
    kw = dict(shape=(32, 64, 128), offsets=O7, vmem_budget=64 * 1024)
    with obs.recording() as rec:
        planner.plan(**kw)   # miss -> compile
        planner.plan(**kw)   # warm hit
    assert rec.counters["plan_cache_miss"] == 1
    assert rec.counters["plan_cache_hit"] == 1
    plans = [s for s in rec.spans if s.name == "plan"]
    assert len(plans) == 2
    assert plans[0].args["key"] == plans[1].args["key"]
    assert plans[0].args["tuned"] is False
    assert plans[0].args["modeled_ms"] > 0
    lookups = [s for s in rec.spans if s.name == "plan_cache_lookup"]
    assert [s.args["outcome"] for s in lookups] == ["miss", "hit"]


def test_planned_call_traces_a_plan_span_every_call(memory_planner,
                                                    tmp_path):
    """A traced planned call takes the frontend's memo of calls, as an
    untraced one does, and still shows its ``plan`` span, as the JAX
    package's frontend does: a memo hit's span carries the memoized
    plan and ``memo="hit"``, and the call launches its decision."""
    (x,) = _data((12, 13, 14))
    first = tst.stencil_pallas(x, O7, W7, device="cpu")
    path = str(tmp_path / "t.json")
    again = tst.stencil_pallas(x, O7, W7, device="cpu", trace=path)
    assert torch.equal(first, again)
    s = summarize(_load(path))
    assert s["n_plan_spans"] == 1
    assert s["counters"]["plan_memo_hit"] == 1
    assert reconcile(s) == []


def test_measure_emits_span_and_counter():
    from repro_torch.runtime.timing import measure

    with obs.recording() as rec:
        res = measure(lambda: sum(range(1000)), reps=3, warmup=1,
                      device="cpu")
    assert res.reps == 3
    spans = [s for s in rec.spans if s.name == "measure"]
    assert len(spans) == 1
    assert spans[0].args["measured_ns"] == rec.counters["measured_ns"]
    assert spans[0].args["device"] == "cpu"
    assert rec.counters["measured_ns"] > 0


def test_cache_stats_callable_and_degrade(tmp_path):
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("file where the cache dir should be")
    cache = PlanCache(cache_dir=str(blocker))
    planner = Planner(cache=cache)
    assert cache.stats["misses"] == 0          # dict spelling
    assert cache.stats()["degraded"] is False  # callable spelling
    with obs.recording() as rec:
        planner.plan(shape=(16, 32, 128), offsets=O7,
                     vmem_budget=64 * 1024)
    assert cache.degraded is True
    snap = cache.stats()
    assert snap["degraded"] is True and snap["disk_errors"] == 1
    assert rec.counters["plan_cache_degrade"] == 1
    assert any(e["name"] == "plan_cache_degrade" for e in rec.events)


def test_tunedb_stats_callable_and_degrade(tmp_path):
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("file where the DB dir should be")
    db = TunedPlanDB(db_dir=str(blocker))
    assert db.stats["misses"] == 0
    assert db.stats()["degraded"] is False
    tuner = AutoTuner(db=db, planner=Planner(cache=PlanCache(
        persistent=False)), k=2, reps=1, warmup=0, device="cpu")
    with obs.recording() as rec:
        tuner.plan(shape=(8, 16, 32), offsets=O7,
                   vmem_budget=16 * 1024, aligned=True)
    assert db.degraded is True
    assert db.stats()["degraded"] is True
    assert rec.counters["tunedb_degrade"] == 1
    assert rec.counters["tunedb_miss"] == 1
    races = [s for s in rec.spans if s.name == "tune_race"]
    assert len(races) == 1
    assert races[0].args["source"] == "measured"
    assert isinstance(races[0].args["never_slower"], bool)
    cands = [s for s in rec.spans if s.name == "tune_candidate"]
    assert [s.args["rank"] for s in cands] == list(range(len(cands)))
    assert len(cands) >= 1
    assert all(s.args["modeled_ms"] > 0 for s in cands)


# -- end to end: a traced, tuned run reconciles ---------------------------------


def test_traced_tuned_run_reconciles(tmp_path, capsys):
    trace = str(tmp_path / "run.json")
    (x,) = _data((12, 16, 32), seed=3)
    w = [1.0 / len(O7)] * len(O7)
    tuner = AutoTuner(
        db=TunedPlanDB(persistent=False),
        planner=Planner(cache=PlanCache(persistent=False)),
        k=2, reps=2, warmup=1, device="cpu",
    )
    out = tst.stencil_iterate(x, O7, w, 3, vmem_budget=32 * 1024,
                              tune=tuner, trace=trace, device="cpu")
    plan = tuner.last_record.winner_plan
    want = tst.stencil_iterate(x, O7, w, 3, plan=plan, device="cpu")
    assert torch.equal(out, want)
    assert not obs.enabled(), "trace= must restore the disabled state"

    doc = validate_trace(_load(trace))
    summary = summarize(doc)
    assert reconcile(summary) == [], "trace does not reconcile"
    assert summary["counters"]["launches"] == len(summary["launches"]) > 0
    # the race: k=2 geometry candidates plus the advisory bf16 and int8
    # storage variants of the T = 3 chain
    assert summary["races"] and summary["races"][0]["candidates"] >= 3
    assert summary["n_measure_spans"] == summary["races"][0]["candidates"]
    launch = summary["launches"][-1]
    assert launch["device"] == "cpu"
    assert launch["modeled_bytes"] > 0 and launch["modeled_ms"] > 0
    assert launch["plan_key"] == plan.request.cache_key()
    assert "tunedb_miss" in summary["counters"]
    # the CLI agrees, and its table says what a span's time is
    assert report_main([trace, "--check"]) == 0
    assert "not the kernel's time" in capsys.readouterr().out


def test_traced_tuned_sharded_run_reconciles(tmp_path):
    """The reference's traced, tuned, 4-shard chain on a CPU mesh: the
    trace reconciles, each launch span carries its shard count and has a
    ``halo_exchange`` span beside it, and the CLI agrees."""
    from repro_torch.kernels.ref import stencil_ref
    from repro_torch.launch.mesh import make_column_mesh

    trace = str(tmp_path / "run.json")
    (x,) = _data((16, 32, 128), seed=0)
    w = [1.0 / len(O7)] * len(O7)
    tuner = AutoTuner(
        db=TunedPlanDB(persistent=False),
        planner=Planner(cache=PlanCache(persistent=False)),
        k=2, reps=2, warmup=1, device="cpu",
    )
    mesh = make_column_mesh(4, device="cpu")
    out = tst.stencil_iterate(x, O7, w, 3, num_shards=4, mesh=mesh,
                              tune=tuner, trace=trace, device="cpu")
    ref = torch.as_tensor(x)
    for _ in range(3):
        ref = stencil_ref(ref, O7, w)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5,
                               rtol=2e-5)
    assert not obs.enabled(), "trace= must restore the disabled state"
    summary = summarize(validate_trace(_load(trace)))
    assert reconcile(summary) == [], "trace does not reconcile"
    assert summary["counters"]["launches"] == len(summary["launches"]) > 0
    # The race's launches exchange too: at least one span a call launch.
    assert summary["n_exchange_spans"] >= len(summary["launches"])
    assert summary["races"] and summary["races"][0]["candidates"] >= 2
    launch = summary["launches"][-1]
    assert launch["num_shards"] == 4
    assert launch["modeled_bytes"] > 0 and launch["fused_depth"] >= 1
    assert report_main([trace, "--check"]) == 0


def test_report_check_fails_on_a_mismatch(tmp_path, capsys):
    with obs.recording() as rec:
        with obs.span("kernel_launch", modeled_bytes=10, modeled_flops=2,
                      ring_smem_bytes=0):
            pass
        obs.add("launches")
        obs.add("modeled_bytes", 11)
        obs.add("modeled_flops", 2)
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(rec.to_trace_events()))
    problems = reconcile(summarize(_load(path)))
    assert problems == ["modeled_bytes counter=11 but launch spans sum to 10"]
    assert report_main([str(path), "--check"]) == 1
    assert "RECONCILIATION MISMATCH" in capsys.readouterr().out
    (tmp_path / "junk.json").write_text("{\"events\": []}")
    assert report_main([str(tmp_path / "junk.json")]) == 2
    assert report_main([str(path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["reconciled"] is False


# -- the frontends ---------------------------------------------------------------


def _frontend_calls(x):
    xs = [x, x * 0.5]
    return {
        "stencil_pallas": lambda **kw: tst.stencil_pallas(
            x, O13, W13, **kw),
        "stencil_iterate": lambda **kw: tst.stencil_iterate(
            x, O7, W7, 3, **kw),
        "multi_stencil_pallas": lambda **kw: tst.multi_stencil_pallas(
            xs, [O13, O7], [W13, W7], **kw),
    }


@pytest.mark.parametrize("frontend", ["stencil_pallas", "stencil_iterate",
                                      "multi_stencil_pallas"])
def test_trace_on_every_frontend(frontend, tmp_path):
    (x,) = _data((12, 13, 14), seed=1)
    call = _frontend_calls(x)[frontend]
    kw = dict(tile=(4, 8, 8), sweep_axis=0, device="cpu")
    path = str(tmp_path / "t.json")
    got = call(trace=path, **kw)
    assert torch.equal(got, call(**kw)), "tracing changed the result"
    s = summarize(_load(path))
    assert reconcile(s) == []
    assert [l["tile"] for l in s["launches"]] == [[4, 8, 8]]
    assert s["launches"][0]["plan_key"] == "<explicit-tile>"
    assert s["launches"][0]["modeled_bytes"] == 0


def test_trace_restores_the_disabled_state_on_error(tmp_path):
    (x,) = _data((12, 13, 14))
    path = tmp_path / "t.json"
    with pytest.raises(ValueError, match="window_kind"):
        tst.stencil_pallas(x, O7, W7, tile=(4, 8, 8), device="cpu",
                           window_kind="diagonal", trace=str(path))
    assert not obs.enabled()
    validate_trace(_load(path))  # written all the same


def test_ring_smem_bytes_is_the_launchs_frontier_memory(tmp_path):
    """A fused launch's ``ring_smem_bytes`` is the frontier part of its
    shared memory as ``core/tiling.py::sweep_smem_bytes`` reckons it,
    under each window kind; a single application has none."""
    (x,) = _data((12, 13, 14), seed=2)
    halos = [halo_from_offsets([O7], 3)] * 3
    for wk in ("ring", "trapezoid"):
        path = str(tmp_path / f"{wk}.json")
        tst.stencil_iterate(x, O7, W7, 3, tile=(4, 8, 8), sweep_axis=1,
                            window_kind=wk, device="cpu", trace=path)
        (launch,) = summarize(_load(path))["launches"]
        whole = sweep_smem_bytes((4, 8, 8), 1, 4, stage_halos=halos,
                                 window_kind=wk)
        ring_only = sweep_smem_bytes((4, 8, 8), 1, 4,
                                     halo=[(3, 3)] * 3)
        assert launch["ring_smem_bytes"] == whole - ring_only > 0
        assert launch["ring_smem_bytes"] == frontier_smem_bytes(
            (4, 8, 8), 1, halos, wk)
    path = str(tmp_path / "one.json")
    tst.stencil_pallas(x, O7, W7, tile=(4, 8, 8), device="cpu", trace=path)
    assert summarize(_load(path))["launches"][0]["ring_smem_bytes"] == 0


def test_spans_bridge_into_the_torch_profiler():
    """With torch imported, each span opens a ``record_function`` range
    of its name, so a ``torch.profiler`` trace files the launch's work
    under ``kernel_launch``."""
    from torch.profiler import ProfilerActivity, profile

    (x,) = _data((12, 13, 14))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.recording():
            tst.stencil_iterate(x, O7, W7, 2, tile=(4, 8, 8), device="cpu")
    names = [e.name for e in prof.events()]
    assert names.count("kernel_launch") == 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.recording(profiler_bridge=False):
            tst.stencil_iterate(x, O7, W7, 2, tile=(4, 8, 8), device="cpu")
    assert "kernel_launch" not in [e.name for e in prof.events()]


# -- parity with the JAX package's spans -------------------------------------

Q = (0.125, 2)  # a power-of-two scale: both packages quantize alike

PARITY = {
    "apply_13pt": lambda: (
        jir.stencil_program(O13, W13), tir.stencil_program(O13, W13)),
    "rhs2": lambda: (
        jir.rhs_program([O13, O7], [W13, W7], d=3),
        tir.rhs_program([O13, O7], [W13, W7], d=3)),
    "chain_T3": lambda: (
        jir.stencil_program(O7, W7, time_steps=3),
        tir.stencil_program(O7, W7, time_steps=3)),
    "chain_dtypes": lambda: (
        jir.stencil_program(O7, W7, time_steps=3,
                            dtypes=["bfloat16", "bfloat16", None]),
        tir.stencil_program(O7, W7, time_steps=3,
                            dtypes=["bfloat16", "bfloat16", None])),
    "chain_int8_reflect": lambda: (
        jir.chain_program([(O7, W7)] * 3, 3, boundary="reflect",
                          quants=[Q, Q, None]),
        tir.chain_program([(O7, W7)] * 3, 3, boundary="reflect",
                          quants=[Q, Q, None])),
}

_SPAN_FIELDS = ("tile", "sweep_axis", "fused_depth", "steps",
                "window_kind", "stage_dtypes")


def _launch_rows(doc, fields):
    return [
        {f: ev["args"].get(f) for f in fields}
        for ev in doc["traceEvents"]
        if ev["ph"] == "X" and ev["name"] == "kernel_launch"
    ]


def _inputs(prog, shape, seed):
    return _data(shape, seed=seed, n=len(prog.inputs()))


@pytest.mark.parametrize("window_kind", ["ring", "trapezoid"])
@pytest.mark.parametrize("case", sorted(PARITY))
def test_launch_spans_equal_jax_at_an_explicit_tile(case, window_kind,
                                                    tmp_path):
    jprog, tprog = PARITY[case]()
    xs = _inputs(tprog, (12, 13, 14), seed=6)
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    kw = dict(tile=(4, 8, 8), sweep_axis=1, window_kind=window_kind)
    want = jst.multi_stencil_pallas([jnp.asarray(x) for x in xs], None, None,
                                    program=jprog, interpret=True,
                                    trace=jpath, **kw)
    got = tst.multi_stencil_pallas(xs, None, None, program=tprog,
                                   device="cpu", trace=tpath, **kw)
    assert np.array_equal(np.asarray(jnp.asarray(want).astype(jnp.float32)),
                          got.float().numpy())
    jdoc, tdoc = _load(jpath), _load(tpath)
    assert _launch_rows(tdoc, _SPAN_FIELDS) == \
        _launch_rows(jdoc, _SPAN_FIELDS)
    assert tdoc["otherData"]["counters"]["launches"] == \
        jdoc["otherData"]["counters"]["launches"]
    assert tdoc["otherData"]["counters"].get("quantized_launches") == \
        jdoc["otherData"]["counters"].get("quantized_launches")
    # the port's trace passes the JAX package's own schema check
    j_validate(tdoc)


@pytest.mark.parametrize("case", ["apply_13pt", "chain_T3",
                                  "chain_int8_reflect"])
def test_launch_spans_equal_jax_at_a_handed_plan(case, tmp_path):
    """The port's planned decision handed to both packages (the JAX side as
    a reference plan): the same launches, split at the plan's depth, with
    the same modelled bytes and flops on every span."""
    jprog, tprog = PARITY[case]()
    shape = (16, 18, 20)
    xs = _inputs(tprog, shape, seed=7)
    lowered = tir.lower(tprog, shape)
    kw = dict(shape=shape, vmem_budget=24 * 1024, n_operands=2)
    if lowered.kind == "chain":
        kw.update(stages=[np.asarray(o) for o, _ in lowered.stages],
                  bcs=tuple(lowered.bcs) if any(lowered.bcs) else None,
                  dtypes=lowered.dtypes)
    else:
        kw.update(offsets=[np.asarray(o) for o, _ in lowered.stages])
    plan = Planner(cache=PlanCache(persistent=False)).plan(**kw)
    ref_plan = jplan.StencilPlan.from_dict(json.loads(plan.to_json()))
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jst.multi_stencil_pallas([jnp.asarray(x) for x in xs], None, None,
                             program=jprog, plan=ref_plan, interpret=True,
                             trace=jpath)
    tst.multi_stencil_pallas(xs, None, None, program=tprog, plan=plan,
                             device="cpu", trace=tpath)
    fields = _SPAN_FIELDS + ("modeled_bytes", "modeled_flops")
    jdoc, tdoc = _load(jpath), _load(tpath)
    rows = _launch_rows(tdoc, fields)
    assert rows == _launch_rows(jdoc, fields)
    assert len(rows) == -(-plan.time_steps // plan.fused_depth)
    assert reconcile(summarize(tdoc)) == []
    j_validate(tdoc)


def test_render_names_every_launch():
    with obs.recording() as rec:
        tst.stencil_iterate(_data((12, 13, 14))[0], O7, W7, 2,
                            tile=(4, 8, 8), device="cpu",
                            dtypes=["bfloat16", None])
    text = render(summarize(rec.to_trace_events()))
    assert "launches: 1" in text
    assert "stage dtypes: bfloat16 -> float32" in text


def test_obs_imports_only_the_standard_library():
    """The recorder, exporter and report import nothing but the standard
    library (the profiler bridge imports torch only when a span opens in
    a process that has it already)."""
    import ast

    obs_dir = Path(recorder.__file__).parent
    for path in sorted(obs_dir.glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [node.module.split(".")[0]]
            else:
                continue
            for root in roots:
                assert root in sys.stdlib_module_names or (
                    root == "torch" and path.name == "recorder.py"), \
                    (path.name, root)
