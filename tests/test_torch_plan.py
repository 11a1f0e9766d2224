"""The port's plan compiler against the JAX package's, on the CPU.

* The paper's steps 1-3 (``lattice_report``, ``pad_plan``) equal the
  reference planner's field for field.
* A plan the reference serialised loads into the port, validates, and
  runs; the port's own plans round-trip through JSON.
* ``tile=None`` (and ``plan=``, ``vmem_budget=``) on ``device="cpu"``
  equal the JAX launch at the port's planned tile, sweep axis, fusion
  depth and window kind exactly — the decision is handed to the JAX
  frontend as a reference plan.  Chains whose depth is below T run as
  several launches on both sides, int8 hand-offs included.
* The planner's invariants under the Hopper time score hold over a seeded
  sweep of shapes and the 19 corpus programs: efficiency ≤ 1, paper ≤
  legacy, the ring's feasible depths contain the trapezoid's, every
  emitted tile fits its kernel's shared memory; with the published H100
  figures the 13-point star three times at 512³ does not fuse.
* The plan cache has its own directory and keys on the card.

The planned launches on the card are in ``test_torch_kernels_cuda.py``.
"""

import dataclasses
import json
from math import prod

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import ir as jir  # noqa: E402
from repro import plan as jplan  # noqa: E402
from repro.kernels import stencil as jst  # noqa: E402
from repro_torch import ir as tir  # noqa: E402
from repro_torch.core.cache_fitting import star_stencil  # noqa: E402
from repro_torch.core.tiling import (  # noqa: E402
    H100_SXM,
    SMEM_BLOCK_LIMIT,
    HopperDevice,
    halo_from_offsets,
    launch_model,
    launch_smem,
)
from repro_torch.kernels import stencil as tst  # noqa: E402
from repro_torch.plan import (  # noqa: E402
    PlanCache,
    PlanMismatchError,
    Planner,
    PlanRequest,
    StencilPlan,
    default_cache_dir,
    planner as planner_mod,
    validate_plan_call,
)
from test_program_fuzz import _build_program, gen_spec  # noqa: E402
from test_torch_kernels_cuda import _corpus_seeds  # noqa: E402

O13 = star_stencil(3, 2)
W13 = np.linspace(-0.4, 0.5, 13).tolist()
O7 = star_stencil(3, 1)
W7 = [-1.5] + [0.25] * 6


class _Recording(Planner):
    """A memory-only planner that keeps every plan it hands out."""

    def __init__(self):
        super().__init__(cache=PlanCache(persistent=False))
        self.plans = []

    def plan(self, request=None, /, **kw):
        p = super().plan(request, **kw)
        self.plans.append(p)
        return p


@pytest.fixture
def recording(monkeypatch):
    rec = _Recording()
    monkeypatch.setattr(planner_mod, "_DEFAULT", rec)
    return rec


def _ref_plan(plan: StencilPlan):
    """The port's decision as a reference plan (its wire format)."""
    return jplan.StencilPlan.from_dict(json.loads(plan.to_json()))


def _data(shape, seed=0, n=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _equal(want, got):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert want.shape == got.shape
    assert np.array_equal(want, got), float(np.abs(want - got).max())


# -- the paper's steps 1-3 ------------------------------------------------------

GEOM_GRIDS = [(45, 91, 24), (64, 91, 60), (90, 182, 24), (16, 33),
              (31, 17, 40)]


@pytest.mark.parametrize("shape", GEOM_GRIDS, ids=str)
@pytest.mark.parametrize("diameter,a", [(5, 1), (3, 2)])
def test_lattice_report_and_pad_plan_equal_reference(shape, diameter, a):
    S = 2 * 512 * 4
    mine = Planner(cache=PlanCache(persistent=False))
    ref = jplan.Planner(cache=jplan.PlanCache(persistent=False))
    rep_t = mine.lattice_report(shape, S, diameter, a)
    rep_j = ref.lattice_report(shape, S, diameter, a)
    assert dataclasses.asdict(rep_t) == dataclasses.asdict(rep_j)
    assert dataclasses.asdict(mine.pad_plan(shape, S, diameter, a)) == \
        dataclasses.asdict(ref.pad_plan(shape, S, diameter, a))


def test_planned_request_runs_steps_1_to_3_with_a_geometry():
    p = Planner(cache=PlanCache(persistent=False))
    unf = p.plan(shape=(45, 91, 24), offsets=O13, geometry=(2, 512, 4),
                 aligned=False)
    fav = p.plan(shape=(64, 91, 60), offsets=O13, geometry=(2, 512, 4),
                 aligned=False)
    assert unf.lattice.unfavorable and unf.pad.nonzero
    assert not fav.lattice.unfavorable and not fav.pad.nonzero
    ref = jplan.Planner(cache=jplan.PlanCache(persistent=False)).plan(
        shape=(45, 91, 24), offsets=O13, geometry=(2, 512, 4), aligned=False,
        vmem_budget=16 * 1024)
    assert unf.pad == StencilPlan.from_dict(ref.to_dict()).pad
    assert p.plan(shape=(45, 91, 24), offsets=O13).lattice is None
    check = p.validate(unf)
    assert check["validated"] and check["miss_reduction_x"] > 1


# -- wire format ---------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(shape=(12, 13, 14), offsets=O13),
    dict(shape=(12, 13, 14), offsets=O13, time_steps=3),
    dict(shape=(41, 53), offsets=star_stencil(2, 2), time_steps=2,
         window_kind="trapezoid"),
], ids=["single", "chain3", "ragged2d"])
def test_reference_plan_loads_validates_and_runs(kw):
    ref = jplan.Planner(cache=jplan.PlanCache(persistent=False)).plan(**kw)
    mine = StencilPlan.from_json(ref.to_json())
    assert mine.tile == ref.tile and mine.fused_depth == ref.fused_depth
    assert mine.request.hardware == H100_SXM.key()
    T = kw.get("time_steps", 1)
    d = len(kw["shape"])
    offs, w = kw["offsets"], np.linspace(-0.4, 0.5, len(kw["offsets"]))
    validate_plan_call(mine, kw["shape"], [offs], 4, time_steps=T,
                       stages=[offs] * T if T > 1 else None)
    (x,) = _data(kw["shape"], seed=3)
    want = jst.stencil_iterate(jnp.asarray(x), offs, w, T, plan=ref,
                               interpret=True)
    got = tst.stencil_iterate(x, offs, w, T, plan=mine, device="cpu")
    _equal(want, got)
    assert len(mine.request.offsets[0][0]) == d


def test_port_plan_round_trips_and_keeps_the_reference_request_fields():
    p = Planner(cache=PlanCache(persistent=False)).plan(
        shape=(20, 24, 40), offsets=O13, time_steps=2,
        bcs=[("neumann", 0.0)] * 2, dtypes=["bfloat16", None])
    assert StencilPlan.from_json(p.to_json()) == p
    kw = dict(shape=(20, 24, 40), offsets=O13, time_steps=2,
              bcs=[("neumann", 0.0)] * 2, dtypes=["bfloat16", None],
              vmem_budget=1 << 16)
    mine = PlanRequest.make(**kw).canonical()
    ref = jplan.PlanRequest.make(**kw).canonical()
    assert tuple(mine.pop("hardware")) == H100_SXM.key()
    mine.pop("version"), ref.pop("version")
    assert mine == ref


def test_plan_mismatch_is_refused():
    p = Planner(cache=PlanCache(persistent=False)).plan(
        shape=(12, 13, 14), offsets=O13)
    (x,) = _data((12, 13, 15))
    with pytest.raises(PlanMismatchError, match="shape"):
        tst.stencil_pallas(x, O13, W13, plan=p, device="cpu")
    (x,) = _data((12, 13, 14))
    with pytest.raises(PlanMismatchError, match="time_steps"):
        tst.stencil_iterate(x, O13, W13, 2, plan=p, device="cpu")


# -- planned launches equal the JAX launch at the same decision ------------------

SINGLE = {
    "star3d": ((12, 13, 14), O13, W13),
    "ragged2d": ((41, 53), star_stencil(2, 2),
                 np.linspace(0.05, -0.35, 9).tolist()),
    "causal1d": ((70,), np.array([[-3], [-2], [-1], [0]]),
                 [0.1, 0.2, 0.3, -0.4]),
}


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("case", sorted(SINGLE))
def test_planned_stencil_equals_jax(case, T, recording):
    shape, offs, w = SINGLE[case]
    (x,) = _data(shape, seed=1)
    got = tst.stencil_iterate(x, offs, w, T, device="cpu")
    (plan,) = recording.plans
    assert plan.time_steps == T and plan.sweep_axis is not None
    want = jst.stencil_iterate(jnp.asarray(x), offs, w, T,
                               plan=_ref_plan(plan), interpret=True)
    _equal(want, got)
    if T == 1:
        got1 = tst.stencil_pallas(x, offs, w, device="cpu")
        assert torch.equal(got1, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_planned_two_rhs_equals_jax(dtype, recording):
    xs = _data((12, 13, 14), seed=2, n=2)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    got = tst.multi_stencil_pallas(
        [torch.from_numpy(x).to(td) for x in xs], [O13, O7], [W13, W7],
        device="cpu")
    (plan,) = recording.plans
    assert plan.request.dtype_bytes == (2 if dtype == "bfloat16" else 4)
    assert plan.kernel == "apply" and len(plan.request.offsets) == 2
    want = jst.multi_stencil_pallas(
        [jnp.asarray(x).astype(jd) for x in xs], [O13, O7], [W13, W7],
        plan=_ref_plan(plan), interpret=True)
    _equal(want, got)


@pytest.mark.parametrize("window_kind", ["ring", "trapezoid"])
@pytest.mark.parametrize("depth", [1, 2])
def test_chain_split_below_t_equals_jax(depth, window_kind):
    """A plan whose fused depth is below T runs ceil(T / depth) launches in
    both packages (the decision forced to ``depth`` for the test)."""
    shape = (16, 18, 20)
    stages = [(O7, W7), (O13, W13), (O7, [0.5] * 7)]
    plan = Planner(cache=PlanCache(persistent=False)).plan(
        shape=shape, stages=[o for o, _ in stages],
        window_kind=window_kind)
    plan = dataclasses.replace(plan, fused_depth=depth,
                               window_kind=window_kind)
    (x,) = _data(shape, seed=4)
    want = jst.stencil_iterate(jnp.asarray(x), stages=stages,
                               plan=_ref_plan(plan), interpret=True)
    got = tst.stencil_iterate(x, stages=stages, plan=plan, device="cpu")
    _equal(want, got)


@pytest.mark.parametrize("forced_depth", [None, 2])
def test_int8_chain_split_across_launches_equals_jax(forced_depth,
                                                     recording):
    """The int8 reflect chain as planned (its depth below T, so launches
    hand int8 codes over through ``in_quant``), and forced to depth 2.  The
    scale is a power of two: the JAX launch on the CPU quantizes with a
    reciprocal multiply, which equals the IEEE quotient the port takes only
    where 1 / scale is exact
    (``test_port_quantizes_with_the_ieee_quotient``)."""
    shape = (16, 18, 20)
    q = (1.0 / 64, 3)
    jprog = jir.chain_program([(O13, W13)] * 3, 3, boundary="reflect",
                              quants=[q, q, None])
    prog = tir.Program.from_json(jprog.serialize())
    (x,) = _data(shape, seed=6)
    x = x * 0.3
    got = tir.run_program(prog, x, device="cpu")
    (plan,) = recording.plans
    assert plan.fused_depth < 3 and plan.kernel == "chain"
    if forced_depth is not None:
        plan = dataclasses.replace(plan, fused_depth=forced_depth)
        got = tir.run_program(prog, x, plan=plan, device="cpu")
    want = jir.run_program(jprog, jnp.asarray(x), plan=_ref_plan(plan),
                           interpret=True)
    _equal(want, got)
    whole = tir.run_program(prog, x, tile=plan.tile, device="cpu")
    assert torch.equal(whole, got)


def test_port_quantizes_with_the_ieee_quotient():
    """At scale 0.02 the second stage's codes of the port equal a numpy
    oracle that divides by the scale (IEEE, half to even); the JAX launch
    on the CPU differs from that oracle by one code, takes the reciprocal
    form ``round(acc · 50)`` there, and does so only where the quotient or
    that product is a half-way value (``ROADMAP.md`` queue C)."""
    q = (0.02, 3)
    shape = (16, 18, 20)
    (x,) = _data(shape, seed=6)
    x = x * 0.3
    jprog = jir.chain_program([(O13, W13)] * 2, 3, quants=[q, q])
    prog = tir.Program.from_json(jprog.serialize())
    got = tir.run_program(prog, x, tile=(4, 8, 8), device="cpu").numpy()
    want = np.asarray(jir.run_program(jprog, jnp.asarray(x), tile=(4, 8, 8),
                                      interpret=True))
    s, zp = np.float32(q[0]), np.float32(q[1])

    def stage(v):
        pad = np.pad(v, 2)
        acc = np.zeros(shape, np.float32)
        for o, w in zip(O13.tolist(), W13):
            sl = tuple(slice(2 + oi, 2 + oi + n) for oi, n in zip(o, shape))
            acc = (acc + np.float32(w) * pad[sl]).astype(np.float32)
        return acc

    codes1 = np.clip(np.round(stage(x) / s) + zp, -128, 127)
    acc2 = stage(((codes1 - zp) * s).astype(np.float32))
    oracle = np.clip(np.round(acc2 / s) + zp, -128, 127)
    assert np.array_equal(got, oracle)
    off = want != oracle
    recip = np.clip(np.round(acc2 * np.float32(1 / q[0])) + zp, -128, 127)
    assert np.array_equal(want[off], recip[off])
    half = (np.abs(acc2[off] / s) % 1 == 0.5) | (
        np.abs(acc2[off] * np.float32(1 / q[0])) % 1 == 0.5)
    assert off.any() and half.all()


def test_vmem_budget_reaches_the_planner(recording):
    (x,) = _data((24, 40, 64), seed=7)
    budget = 16 * 1024
    got = tst.stencil_iterate(x, O13, W13, 2, vmem_budget=budget,
                              device="cpu")
    (plan,) = recording.plans
    assert plan.request.vmem_budget == budget
    assert 0 < plan.vmem_bytes <= budget
    want = jst.stencil_iterate(jnp.asarray(x), O13, W13, 2,
                               plan=_ref_plan(plan), interpret=True)
    _equal(want, got)
    big = tst.stencil_iterate(x, O13, W13, 2, device="cpu")
    assert recording.plans[-1].vmem_bytes > budget
    assert torch.equal(big, got)


def test_own_plan_is_accepted_by_plan_argument():
    p = Planner(cache=PlanCache(persistent=False)).plan(
        shape=(12, 13, 14), offsets=O13, time_steps=2)
    (x,) = _data((12, 13, 14), seed=8)
    want = jst.stencil_iterate(jnp.asarray(x), O13, W13, 2,
                               plan=_ref_plan(p), interpret=True)
    _equal(want, tst.stencil_iterate(x, O13, W13, 2, plan=p, device="cpu"))


CORPUS = _corpus_seeds()


@pytest.mark.parametrize("seed", CORPUS)
def test_planned_corpus_program_equals_jax(seed, recording):
    spec = gen_spec(seed)
    jprog = _build_program(spec)
    prog = tir.Program.from_json(jprog.serialize())
    u = np.random.default_rng(spec["seed"]).standard_normal(
        spec["shape"]).astype(np.float32)
    got = tir.run_program(prog, u, device="cpu")
    (plan,) = recording.plans
    _invariants(plan)
    want = jir.run_program(jprog, jnp.asarray(u), plan=_ref_plan(plan),
                           interpret=True)
    _equal(want, got)


# -- invariants of the time score ------------------------------------------------


def _invariants(plan: StencilPlan, legacy: StencilPlan | None = None):
    assert 0.0 <= plan.efficiency <= 1.0
    assert plan.modeled_ms <= plan.legacy_modeled_ms
    assert plan.modeled_ms <= plan.single_pass_modeled_ms
    assert dict(plan.depth_ms)[1] == plan.single_pass_modeled_ms
    assert plan.modeled_ms == min(ms for _, ms in plan.depth_ms)
    if legacy is not None:
        assert plan.modeled_ms <= legacy.modeled_ms
    req = plan.request
    assert 0 < plan.vmem_bytes <= min(req.vmem_budget, SMEM_BLOCK_LIMIT)
    d = len(req.shape)
    if req.stages and (plan.fused_depth > 1 or plan.kernel == "chain"):
        stage_halos = [halo_from_offsets([st.offsets], d)
                       for st in req.stages[:plan.fused_depth]]
        halo = halo_from_offsets([st.offsets for st in
                                  req.stages[:plan.fused_depth]], d)
        smem = launch_smem("chain", req.shape, plan.tile, plan.sweep_axis,
                           req.dtype_bytes, halo, stage_halos, 1,
                           req.pipelined, plan.window_kind)
        assert plan.kernel == "chain"
    else:
        offs = [req.stages[0].offsets] if req.stages else req.offsets
        smem = launch_smem("apply", req.shape, plan.tile, plan.sweep_axis,
                           req.dtype_bytes, halo_from_offsets(offs, d),
                           n_inputs=len(req.offsets),
                           pipelined=req.pipelined)
    if not req.stages or len({st.offsets for st in req.stages}) == 1:
        assert plan.vmem_bytes == smem
    assert H100_SXM.ctas_per_sm(plan.kernel, plan.vmem_bytes) \
        == plan.ctas_per_sm >= 1


def _sweep_cases():
    rng = np.random.default_rng(17)
    cases = []
    for i in range(8):
        d = int(rng.integers(2, 4))
        shape = tuple(int(n) for n in rng.integers(6, 140, size=d))
        offs = star_stencil(d, int(rng.integers(1, 3)))
        kind = ("single", "chain", "rhs", "dtypes")[i % 4]
        db = int(rng.choice([2, 4]))
        cases.append((shape, offs, kind, db))
    return cases


@pytest.mark.parametrize("shape,offs,kind,db", _sweep_cases(),
                         ids=lambda v: str(v) if isinstance(v, tuple)
                         else None)
def test_invariants_over_seeded_shapes(shape, offs, kind, db):
    kw = dict(shape=shape, dtype_bytes=db)
    if kind == "rhs":
        kw["offsets"] = [offs, offs[::-1]]
    else:
        kw["offsets"] = offs
        if kind in ("chain", "dtypes"):
            kw["time_steps"] = 3
        if kind == "dtypes":
            kw["dtypes"] = ["bfloat16", "bfloat16", None]
    p = Planner(cache=PlanCache(persistent=False))
    plan = p.plan(**kw)
    legacy = Planner("legacy", PlanCache(persistent=False)).plan(**kw)
    _invariants(plan, legacy)
    if kw.get("time_steps", 1) > 1:
        trap = p.plan(**kw, window_kind="trapezoid")
        ring = p.plan(**kw, window_kind="ring")
        _invariants(trap)
        assert {dd for dd, _ in ring.depth_ms} >= {dd for dd, _ in
                                                    trap.depth_ms}
        assert ring.modeled_ms <= trap.modeled_ms
        assert plan.window_kind == "ring"


def test_three_applications_of_the_star_do_not_fuse_on_an_h100():
    plan = Planner(cache=PlanCache(persistent=False)).plan(
        shape=(512, 512, 512), offsets=O13, time_steps=3)
    assert plan.request.hardware == H100_SXM.key()
    assert plan.fused_depth == 1 and plan.kernel == "apply"
    depth_ms = dict(plan.depth_ms)
    assert depth_ms[1] < depth_ms[2] < depth_ms[3]
    # A tight budget (the smem of one CTA at a small tile) still plans.
    small = Planner(cache=PlanCache(persistent=False)).plan(
        shape=(512, 512, 512), offsets=O13, time_steps=3,
        vmem_budget=32 * 1024)
    assert small.vmem_bytes <= 32 * 1024


def test_issue_costs_reproduce_the_measurements_they_came_from():
    """The issue-cost constants were derived from the device times of
    apply_f32_512 (0.6089 ms) and chain_T3_512 (3.835 ms) on an H100 80GB
    HBM3 at 700 W; the model gives them back at those geometries."""
    h = [(2, 2)] * 3
    smem = launch_smem("apply", (512,) * 3, (8, 16, 32), 0, 4, h)
    m = launch_model("apply", (512,) * 3, (8, 16, 32), 0, [h], [13], smem)
    assert m["ms"] == pytest.approx(0.6089, rel=1e-12)
    assert m["ctas_per_sm"] == 2 and m["issue_ms"] > m["bytes_ms"]
    smem = launch_smem("chain", (512,) * 3, (4, 16, 32), 0, 4, h, [h] * 3)
    m = launch_model("chain", (512,) * 3, (4, 16, 32), 0, [h] * 3, [13] * 3,
                     smem)
    assert m["ms"] == pytest.approx(3.835, rel=1e-12)
    assert m["ctas_per_sm"] == 1


def test_candidates_start_with_the_plan_and_all_run():
    p = Planner(cache=PlanCache(persistent=False))
    kw = dict(shape=(16, 18, 20), offsets=O13, time_steps=2)
    cands = p.candidates(k=4, **kw)
    assert cands[0] == p.plan(**kw) and len(cands) >= 2
    assert [c.modeled_ms for c in cands[1:]] == sorted(
        c.modeled_ms for c in cands[1:])
    (x,) = _data(kw["shape"], seed=9)
    outs = [tst.stencil_iterate(x, O13, W13, 2, plan=c, device="cpu")
            for c in cands]
    assert all(torch.equal(o, outs[0]) for o in outs)


def test_sharded_requests_name_their_roadmap_item():
    """A sharded request, once refused naming ``ROADMAP.md`` item 11, now
    plans the worst shard's slab: the reference's
    ``test_plan_v4_shard_fields`` on the port's planner, plus the
    exchange bytes of a split chain at the stages' own widths and the
    alternative shard axes among the candidates."""
    planner = Planner(cache=PlanCache(persistent=False))
    kw = dict(shape=(256, 256, 256), offsets=O13, vmem_budget=16 << 20,
              aligned=True)
    base = planner.plan(**kw)
    p4 = planner.plan(**kw, num_shards=4)
    assert base.num_shards == 1 and base.shard_axis is None
    assert base.halo_exchange_bytes == 0
    assert base.per_shard_traffic_bytes == base.traffic_bytes
    assert p4.shard_axis is not None and p4.shard_axis != p4.sweep_axis
    assert p4.halo_exchange_bytes > 0
    assert p4.per_shard_traffic_bytes <= base.traffic_bytes / 2
    assert p4.modeled_ms < base.modeled_ms
    assert p4.grid == tuple(-(-256 // t) for t in p4.tile)
    assert StencilPlan.from_json(p4.to_json()) == p4
    assert planner.plan(**kw, num_shards=1) == base
    # Each launch of a split chain exchanges its input at that input's
    # width: the int8 codes of a quantized stage move a byte an element.
    req = dict(shape=(64, 64, 128), stages=[O7] * 3, num_shards=2,
               dtypes=("int8", "int8", None), bcs=(("reflect", 0.0),) * 3)
    split = next(p for p in planner.candidates(k=8, **req)
                 if p.fused_depth == 1)
    a = split.shard_axis
    ext = prod(g * t + 2 for i, (g, t) in enumerate(zip(split.grid,
                                                          split.tile))
               if i != a)
    assert split.halo_exchange_bytes == (4 + 1 + 1) * 2 * ext
    # The race sees the other partitions too.
    cands = planner.candidates(k=6, **kw, num_shards=4)
    assert cands[0] == p4
    assert len({c.shard_axis for c in cands}) > 1
    assert all(c.shard_axis != c.sweep_axis for c in cands)


# -- the plan cache ---------------------------------------------------------------


def test_plan_cache_has_its_own_directory(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_PLAN_CACHE_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert default_cache_dir() == str(
        tmp_path / "home" / ".cache" / "repro_torch" / "plans")
    assert default_cache_dir() != jplan.default_cache_dir()
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE_DIR", str(tmp_path / "env"))
    monkeypatch.setenv("REPRO_PLAN_CACHE_DIR", str(tmp_path / "ref"))
    assert default_cache_dir() == str(tmp_path / "env")
    cache = PlanCache()
    plan = Planner(cache=cache).plan(shape=(12, 13, 14), offsets=O13)
    files = list((tmp_path / "env").glob("*.json"))
    assert [f.stem for f in files] == [plan.request.cache_key()]
    assert not (tmp_path / "ref").exists()
    fresh = PlanCache()
    assert fresh.get(plan.request.cache_key()) == plan
    assert fresh.stats["disk_hits"] == 1


def test_plan_cache_keys_on_the_card(tmp_path):
    other = dataclasses.replace(H100_SXM, name="H100 PCIe", sm_count=114)
    kw = dict(shape=(64, 64, 256), offsets=O13)
    a, b = PlanRequest.make(**kw), PlanRequest.make(**kw, hardware=other)
    assert a.cache_key() != b.cache_key()
    assert HopperDevice.from_key(b.hardware) == other
    p = Planner(cache=PlanCache(cache_dir=str(tmp_path)))
    pa, pb = p.plan(a), p.plan(b)
    assert pa.request.hardware != pb.request.hardware
    assert len(list(tmp_path.glob("*.json"))) == 2
    fresh = Planner(cache=PlanCache(cache_dir=str(tmp_path)))
    assert fresh.plan(b) == pb and fresh.plan(a) == pa


def test_repeated_planned_call_is_answered_from_the_memo(recording):
    """The frontend's warm path: a repeated call with the same static
    arguments is answered from ``Planner.plan_call``'s memo without
    building a request; another budget plans anew."""
    (x,) = _data((12, 13, 14), seed=11)
    a = tst.stencil_iterate(x, O13, W13, 2, device="cpu")
    b = tst.stencil_iterate(x, O13, W13, 2, device="cpu")
    assert torch.equal(a, b) and len(recording.plans) == 1
    tst.stencil_iterate(x, O13, W13, 2, vmem_budget=1 << 15, device="cpu")
    assert len(recording.plans) == 2
    assert len(recording._by_call) == 2
