"""The port's call memo (``kernels/stencil.py``, ``_CALL_MEMO``) on the CPU.

A repeated untraced call whose launches are all plain applications goes
from ``multi_stencil_pallas`` straight to its bound launches.  Here, on
the kernels' plain versions:

* a repeat is a hit, bit-equal to the miss and close to a float64
  reference, at T=1, at T=4 split into depth-1 launches and with p=2;
* every value the launches consume is part of the key, by content: an
  offsets array changed in place, a changed weight (``-0.0`` against
  ``0.0``), the shape, dtype, strides, ``time_steps``, ``tile``,
  ``dtypes`` and ``device`` each miss and give the new result;
* what the memo does not serve counts neither a hit nor a miss:
  ``trace=``, ``tune=``, ``plan=``, ``program=``, ``num_shards=``, an
  installed recorder, a fused chain, an input that is not a contiguous
  tensor on the call's device;
* an entry made under another planner object serves nothing, nor does a
  planner with a tuned DB;
* 256 entries are kept, the oldest dropped first;
* a hit opens ``frontend``, ``decide``, ``launch_buffers`` and
  ``sweep_launch`` once a launch and is warm; a miss is cold;
* the entry a miss stores is the resolved call it ran, and a hit runs
  the same launch objects; a fused chain stores nothing; the binder
  ``_resolve`` binds through (``bind_apply``) is called once a launch on
  a miss and never on a hit, and an entry it bound serves no call once
  the binder is restored;
* a one-shard mesh launches the bound plain application, as an
  unsharded call does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import ir as tir  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.cache_fitting import star_stencil  # noqa: E402
from repro_torch.kernels import stencil as tst  # noqa: E402
from repro_torch.plan import (  # noqa: E402
    AutoTuner,
    PlanCache,
    Planner,
    TunedPlanDB,
)
from repro_torch.plan import planner as planner_mod  # noqa: E402

O13 = np.asarray(star_stencil(3, 2), dtype=np.int64)
W13 = [float(v) for v in np.linspace(-0.4, 0.5, 13)]
O7 = np.asarray(star_stencil(3, 1), dtype=np.int64)
W7 = [-1.5] + [0.25] * 6
SHAPE = (12, 13, 16)
MEMO = ("call_memo.hit", "call_memo.miss")


@pytest.fixture(autouse=True)
def planner(monkeypatch):
    """An empty call memo, and a default planner that is memory-only."""
    assert obs.active() is None
    monkeypatch.setattr(tst, "_CALL_MEMO", {})
    p = Planner(cache=PlanCache(persistent=False))
    monkeypatch.setattr(planner_mod, "_DEFAULT", p)
    return p


def _t(shape=SHAPE, seed=0, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(dtype)


def _memo(fn):
    """``fn()``'s result and the change of the two memo counters."""
    before = obs.totals()
    out = fn()
    after = obs.totals()
    return out, tuple(after[k] - before[k] for k in MEMO)


def _whole_path(fn):
    """``fn()`` as it runs without the memo: under a recorder."""
    with obs.recording():
        return fn()


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int16 if a.element_size() == 2 else torch.int32),
        b.view(torch.int16 if b.element_size() == 2 else torch.int32))


def _ref(us, offsets, weights, steps=1):
    """Σ_p Σ_taps w·u_p[x + o] in float64, zero outside the grid, applied
    ``steps`` times (single RHS)."""
    out = None
    for _ in range(steps):
        acc = torch.zeros(us[0].shape, dtype=torch.float64)
        for u, offs, ws in zip(us, offsets, weights):
            r = int(np.abs(np.asarray(offs)).max())
            pad = torch.nn.functional.pad(u.double(), [r] * 2 * u.ndim)
            for o, w in zip(np.asarray(offs).tolist(), ws):
                acc += w * pad[tuple(slice(r + a, r + a + n)
                                     for a, n in zip(o, u.shape))]
        out = acc
        us = [acc]
    return out


def _split_at_depth_1(planner, shape, offsets):
    """Have ``planner`` answer every call with its plan of one application
    of ``offsets`` (fused depth 1): a T-step loop then runs as T plain
    applications."""
    plan = planner.plan(shape=shape, offsets=offsets)
    assert plan.fused_depth == 1
    planner.plan_call = lambda signature, **kw: plan


@pytest.mark.parametrize("case", ["T1", "T4_split", "p2"])
def test_a_repeat_is_a_hit_equal_to_the_miss_and_the_reference(case,
                                                               planner):
    x, y = _t(seed=1), _t(seed=2)
    if case == "T1":
        call = lambda: tst.stencil_pallas(x, O13, W13,  # noqa: E731
                                          device="cpu")
        want = _ref([x], [O13], [W13])
    elif case == "T4_split":
        _split_at_depth_1(planner, SHAPE, O7)
        call = lambda: tst.stencil_iterate(x, O7, W7, 4,  # noqa: E731
                                           device="cpu")
        want = _ref([x], [O7], [W7], steps=4)
    else:
        args = ([x, y], [O13, O7], [W13, W7])
        call = lambda: tst.multi_stencil_pallas(  # noqa: E731
            *args, device="cpu")
        want = _ref(*args)
    miss, counts = _memo(call)
    assert counts == (0, 1)
    hit, counts = _memo(call)
    assert counts == (1, 0)
    assert _same_bits(hit, miss)
    assert _same_bits(hit, _whole_path(call))
    scale = float(want.abs().max())
    assert float((hit.double() - want).abs().max()) <= 1e-5 * scale


CHANGES = ["offsets_in_place", "weights", "negative_zero", "shape", "dtype",
           "strides", "time_steps", "tile", "dtypes", "device"]


def _change(case):
    """The first call and the changed one, each a function of the offsets
    array (which one case changes in place)."""
    x = _t()
    strided = torch.empty_strided((1, 13, 16), (999, 16, 1))
    strided.copy_(_t((1, 13, 16)))

    def call(u=x, w=W13, device="cpu", **kw):
        return lambda o: tst.stencil_pallas(u, o, w, device=device, **kw)

    def in_place(o):
        o[:] = -O13  # the mirrored taps: the weights are not symmetric
        return tst.stencil_pallas(x, o, W13, device="cpu")

    return {
        "offsets_in_place": (call(), in_place),
        "weights": (call(), call(w=[0.5] + W13[1:])),
        "negative_zero": (call(w=[0.0] + W13[1:]),
                          call(w=[-0.0] + W13[1:])),
        "shape": (call(), call(u=_t((12, 13, 17)))),
        "dtype": (call(), call(u=x.to(torch.bfloat16))),
        "strides": (call(u=strided.clone(
            memory_format=torch.contiguous_format)), call(u=strided)),
        "time_steps": (call(time_steps=1), call(time_steps=2)),
        "tile": (call(tile=(4, 8, 8)), call(tile=(4, 8, 16))),
        "dtypes": (call(), call(dtypes=["float32"])),
        "device": (call(), call(device=torch.device("cpu"))),
    }[case]


@pytest.mark.parametrize("case", CHANGES)
def test_a_changed_value_misses_and_gives_the_new_result(case, planner):
    if case == "time_steps":
        # Both calls planned at depth 1: one and two plain applications.
        _split_at_depth_1(planner, SHAPE, O13)
    first, second = _change(case)
    offs = O13.copy()
    was, counts = _memo(lambda: first(offs))
    assert counts == (0, 1)
    _, counts = _memo(lambda: first(offs))
    assert counts == (1, 0)
    got, counts = _memo(lambda: second(offs))
    assert counts == (0, 1)
    assert _same_bits(got, _whole_path(lambda: second(offs)))
    if case in ("offsets_in_place", "weights", "time_steps"):
        assert not torch.equal(got, was)


def _bypasses(tmp_path, planner):
    x = _t()
    plan = planner.plan(shape=SHAPE, offsets=O7)
    prog = tir.stencil_program(O7, W7, time_steps=1, d=3)
    tuner = AutoTuner(db=TunedPlanDB(persistent=False),
                      planner=Planner(cache=PlanCache(persistent=False)),
                      k=2, reps=1, warmup=0, device="cpu")
    noncontiguous = _t((16, 13, 12)).transpose(0, 2)

    def recorded():
        with obs.recording():
            return tst.stencil_pallas(x, O7, W7, device="cpu")

    return {
        "trace": lambda: tst.stencil_pallas(
            x, O7, W7, device="cpu", trace=str(tmp_path / "t.json")),
        "tune": lambda: tst.stencil_pallas(x, O7, W7, device="cpu",
                                           tune=tuner),
        "plan": lambda: tst.stencil_pallas(x, O7, W7, device="cpu",
                                           plan=plan),
        "program": lambda: tst.multi_stencil_pallas(
            [x], None, None, program=prog, device="cpu"),
        "num_shards": lambda: tst.stencil_pallas(
            _t((16, 16, 16)), O7, W7, tile=(4, 8, 16), sweep_axis=0,
            num_shards=2, shard_axis=1, device="cpu"),
        "recorder": recorded,
        "fused_chain": lambda: tst.stencil_iterate(
            x, O7, W7, 2, tile=(4, 8, 8), device="cpu"),
        "noncontiguous": lambda: tst.stencil_pallas(
            noncontiguous, O7, W7, device="cpu"),
        "numpy": lambda: tst.stencil_pallas(x.numpy(), O7, W7,
                                            device="cpu"),
    }


@pytest.mark.parametrize("case", ["trace", "tune", "plan", "program",
                                  "num_shards", "recorder", "fused_chain",
                                  "noncontiguous", "numpy"])
def test_what_the_memo_does_not_serve_counts_neither(case, tmp_path,
                                                     planner):
    call = _bypasses(tmp_path, planner)[case]
    first, counts = _memo(call)
    assert counts == (0, 0)
    again, counts = _memo(call)
    assert counts == (0, 0)
    assert _same_bits(first, again)


def test_a_fresh_planner_or_a_tuned_db_is_not_served(planner, monkeypatch):
    x = _t()
    call = lambda: tst.stencil_pallas(x, O13, W13,  # noqa: E731
                                      device="cpu")
    first, _ = _memo(call)
    assert _memo(call)[1] == (1, 0)
    fresh = Planner(cache=PlanCache(persistent=False))
    monkeypatch.setattr(planner_mod, "_DEFAULT", fresh)
    got, counts = _memo(call)
    assert counts == (0, 1) and _same_bits(got, first)
    assert len(fresh._by_call) == 1  # the fresh planner decided the call
    (entry,) = tst._CALL_MEMO.values()
    assert entry.planner is fresh
    tuned = Planner(cache=PlanCache(persistent=False),
                    tuned_db=TunedPlanDB(persistent=False), device="cpu")
    monkeypatch.setattr(planner_mod, "_DEFAULT", tuned)
    for _ in range(2):
        got, counts = _memo(call)
        assert counts == (0, 0) and _same_bits(got, first)
    assert tst._CALL_MEMO[next(iter(tst._CALL_MEMO))].planner is fresh


def test_the_memo_keeps_256_entries_and_drops_the_oldest_first():
    x = _t((4, 4, 8))

    def call(i):
        return tst.stencil_pallas(x, O7, [w * (1 + i) for w in W7],
                                  tile=(4, 4, 8), device="cpu")

    for i in range(tst._CALL_MEMO_MAX + 1):
        assert _memo(lambda: call(i))[1] == (0, 1)
    assert len(tst._CALL_MEMO) == tst._CALL_MEMO_MAX == 256
    assert _memo(lambda: call(1))[1] == (1, 0)   # the oldest kept
    assert _memo(lambda: call(0))[1] == (0, 1)   # dropped; drops 1
    assert len(tst._CALL_MEMO) == 256
    assert _memo(lambda: call(1))[1] == (0, 1)
    assert _memo(lambda: call(256))[1] == (1, 0)


@pytest.mark.parametrize("steps", [1, 4])
def test_a_hit_opens_each_stage_once_a_launch_and_is_warm(steps, planner):
    x = _t()
    if steps > 1:
        _split_at_depth_1(planner, SHAPE, O7)
    call = lambda: tst.stencil_iterate(x, O7, W7, steps,  # noqa: E731
                                       device="cpu")
    before = obs.totals()
    call()
    mid = obs.totals()
    cold = {k: mid["cold"][k] - before["cold"][k] for k in mid["cold"]}
    assert cold["calls"] == cold["cold_calls"] == cold["call_memo.miss"] == 1
    assert all(mid["warm"][k] == before["warm"][k] for k in mid["warm"])
    call()
    after = obs.totals()
    warm = {k: after["warm"][k] - mid["warm"][k] for k in after["warm"]}
    assert all(after["cold"][k] == mid["cold"][k] for k in after["cold"])
    assert warm["calls"] == warm["call_memo.hit"] == 1
    assert warm["frontend.n"] == warm["decide.n"] == 1
    assert warm["launch_buffers.n"] == warm["sweep_launch.n"] == steps
    assert warm["launch_buffers.direct"] == warm["device_ops.kernel"] == steps
    assert warm["plan_memo_hit"] == warm["plan_memo_miss"] == 0


def test_the_miss_stores_the_call_it_ran_and_a_hit_runs_its_launches(
        planner, monkeypatch):
    x = _t()
    _split_at_depth_1(planner, SHAPE, O7)
    ran = []
    run = tst._run

    def watched(call, us):
        ran.append((call, call.launches))
        return run(call, us)

    monkeypatch.setattr(tst, "_run", watched)
    call = lambda: tst.stencil_iterate(x, O7, W7, 4,  # noqa: E731
                                       device="cpu")
    miss, counts = _memo(call)
    assert counts == (0, 1)
    (entry,) = tst._CALL_MEMO.values()
    assert ran == [(entry, entry.launches)]
    assert entry.memo and len(entry.launches) == 4
    hit, counts = _memo(call)
    assert counts == (1, 0)
    assert ran[1][0] is entry and ran[1][1] is ran[0][1]
    assert _same_bits(hit, miss)


def test_a_fused_chain_signature_leaves_the_memo_empty():
    x = _t()
    call = lambda: tst.stencil_iterate(x, O7, W7, 2,  # noqa: E731
                                       tile=(4, 8, 8), device="cpu")
    first, counts = _memo(call)
    assert counts == (0, 0) and tst._CALL_MEMO == {}
    again, counts = _memo(call)
    assert counts == (0, 0) and tst._CALL_MEMO == {}
    assert _same_bits(first, again)
    assert _same_bits(first, _whole_path(call))


def _counting_binder(bound, ran):
    """A binder over ``bind_apply`` whose launches append themselves to
    ``ran`` when run; each launch it binds is appended to ``bound``."""
    bind = tst.bind_apply

    def binder(*args, **kw):
        launch = bind(*args, **kw)

        def counted(bufs):
            ran.append(counted)
            return launch(bufs)

        bound.append(counted)
        return counted

    return binder


def test_the_swapped_binder_is_what_a_miss_launches_and_a_hit_not_binds(
        planner, monkeypatch):
    x = _t()
    _split_at_depth_1(planner, SHAPE, O7)
    bound, ran = [], []
    monkeypatch.setattr(tst, "bind_apply", _counting_binder(bound, ran))
    call = lambda: tst.stencil_iterate(x, O7, W7, 4,  # noqa: E731
                                       device="cpu")
    miss, counts = _memo(call)
    assert counts == (0, 1)
    assert len(bound) == 4 and ran == bound  # each bound launch ran once
    hit, counts = _memo(call)
    assert counts == (1, 0)
    assert len(bound) == 4 and ran == bound + bound  # nothing bound again
    assert _same_bits(hit, miss)
    want = _ref([x], [O7], [W7], steps=4)
    scale = float(want.abs().max())
    assert float((hit.double() - want).abs().max()) <= 1e-5 * scale


def test_a_restored_binder_is_what_the_next_call_launches(monkeypatch):
    x = _t()
    bind = tst.bind_apply
    bound, ran = [], []
    monkeypatch.setattr(tst, "bind_apply", _counting_binder(bound, ran))
    call = lambda: tst.stencil_pallas(x, O13, W13,  # noqa: E731
                                      device="cpu")
    swapped, counts = _memo(call)
    assert counts == (0, 1) and len(bound) == len(ran) == 1
    monkeypatch.setattr(tst, "bind_apply", bind)
    got, counts = _memo(call)
    assert counts == (0, 1) and len(ran) == 1  # no swapped launch ran
    (entry,) = tst._CALL_MEMO.values()
    assert entry.binder is bind
    again, counts = _memo(call)
    assert counts == (1, 0) and len(ran) == 1
    assert _same_bits(got, swapped) and _same_bits(again, swapped)


def test_a_one_shard_mesh_launches_the_bound_plain_application(monkeypatch):
    from repro_torch.launch.mesh import make_column_mesh
    from repro_torch.parallel import shard_columns as tsc

    x = _t()
    want = _whole_path(lambda: tst.stencil_pallas(x, O13, W13,
                                                  device="cpu"))
    bound, ran = [], []
    monkeypatch.setattr(tst, "bind_apply", _counting_binder(bound, ran))
    mesh = make_column_mesh(1, device="cpu")
    got, counts = _memo(lambda: tst.stencil_pallas(x, O13, W13, mesh=mesh,
                                                   device="cpu"))
    assert counts == (0, 0) and tst._CALL_MEMO == {}
    assert len(bound) == len(ran) == 1
    assert _same_bits(got, want)
    ow = ((tuple(map(tuple, O13.tolist())), tuple(W13)),)
    direct = tsc.sharded_stencil_call((x,), ow, (4, 8, 8), 0, True,
                                      num_shards=1)
    assert len(bound) == len(ran) == 2
    assert _same_bits(direct, tst._stencil_call((x,), ow, (4, 8, 8), 0,
                                                True))
