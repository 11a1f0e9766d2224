"""Column sharding of the port against the JAX package, on the CPU.

Every sharded launch must equal, bit for bit, the port's unsharded launch
of the same call and the JAX launch named in each test (Pallas in
interpret mode; ``tests/conftest.py`` pins 4 host devices, so the JAX
sharded launch runs on a real 4-device mesh).  The port's CPU mesh puts
its shards on the CPU (``make_column_mesh(N, device="cpu")``), each shard
running the kernels' plain versions on its own column slab with its own
origin.

Covered: every case of ``tests/test_shard_columns.py`` (parity at T = 1
over 2 and 4 shards, divisible and not; chains T ∈ {1, 3}; the
heterogeneous chain; the planner-driven launch; an explicit mesh; more
shards than columns; one shard; the axis-pin collision; the validation
errors, with the same exception types; a reference v4 plan with shard
fields loaded and run); the sharded cases of
``tests/test_ring_windows.py``, ``tests/test_boundary_menu.py`` (every
boundary kind; periodic with a ragged last shard) and ``tests/test_ir.py``
(a neumann program); the int8 zero-point case, where the port's sharded
launch equals the JAX *single-device* launch and the JAX sharded launch
does not (its mesh-edge shards read ``ppermute``'s code 0, not the zero
point); the exchange counters against the JAX package's and the plan's;
the mesh's refusals; and, on a machine with two cards, a two-card mesh.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import ir as jir  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro import plan as jplan  # noqa: E402
from repro.kernels import stencil as jst  # noqa: E402
from repro.parallel import shard_columns as jsc  # noqa: E402
from repro_torch import ir as tir  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.cache_fitting import star_stencil  # noqa: E402
from repro_torch.kernels import stencil as tst  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    ModelMesh,
    make_column_mesh,
    make_test_mesh,
)
from repro_torch.parallel import shard_columns as tsc  # noqa: E402
from repro_torch.plan import (  # noqa: E402
    PlanCache,
    Planner,
    PlanRequest,
    StencilPlan,
)
from repro_torch.plan import planner as planner_mod  # noqa: E402

OFFS = star_stencil(3, 1)
WEIGHTS = [0.05 * (i + 1) for i in range(len(OFFS))]
CPU = dict(device="cpu")


def _needs(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} JAX devices (tests/conftest.py forces 4)")


def _u(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _equal(*outs):
    """All outputs bit-equal (as f32 arrays of one shape)."""
    arrs = [np.asarray(o, dtype=np.float32) for o in outs]
    for a in arrs[1:]:
        assert a.shape == arrs[0].shape
        assert np.array_equal(a, arrs[0]), float(np.abs(a - arrs[0]).max())


@pytest.fixture(autouse=True)
def memory_planner(monkeypatch):
    """The port's default planner, memory-only: nothing lands in ~."""
    p = Planner(cache=PlanCache(persistent=False))
    monkeypatch.setattr(planner_mod, "_DEFAULT", p)
    return p


def _ref_plan(plan: StencilPlan):
    return jplan.StencilPlan.from_dict(json.loads(plan.to_json()))


# -- tests/test_shard_columns.py ----------------------------------------------


@pytest.mark.parametrize("num_shards", [2, 4])
@pytest.mark.parametrize("shape,tile", [
    ((16, 24, 130), (4, 8, 64)),   # 3 columns on axis 1: not divisible
    ((12, 32, 130), (4, 8, 128)),  # 4 columns on axis 1: divisible by 2
])
def test_sharded_bitwise_parity_t1(shape, tile, num_shards):
    _needs(num_shards)
    x = _u(shape)
    kw = dict(tile=tile, sweep_axis=0)
    base = tst.stencil_pallas(x, OFFS, WEIGHTS, **kw, **CPU)
    got = tst.stencil_pallas(x, OFFS, WEIGHTS, num_shards=num_shards, **kw,
                             **CPU)
    want = jst.stencil_pallas(jnp.asarray(x), OFFS, WEIGHTS,
                              num_shards=num_shards, interpret=True, **kw)
    _equal(got, base, want)


@pytest.mark.parametrize("time_steps", [1, 3])
def test_sharded_bitwise_parity_stage_chain(time_steps):
    """Fused chains shard as single applications do: frontiers are
    per-column state and the masks are lifted by each shard's origin."""
    _needs(2)
    x = _u((16, 24, 130), seed=1)
    kw = dict(tile=(4, 8, 64), sweep_axis=0)
    base = tst.stencil_iterate(x, OFFS, WEIGHTS, time_steps, **kw, **CPU)
    got = tst.stencil_iterate(x, OFFS, WEIGHTS, time_steps, num_shards=2,
                              **kw, **CPU)
    want = jst.stencil_iterate(jnp.asarray(x), OFFS, WEIGHTS, time_steps,
                               num_shards=2, interpret=True, **kw)
    _equal(got, base, want)


def test_sharded_heterogeneous_stage_chain():
    """Distinct per-stage operators (star then an asymmetric shift): the
    exchange carries the chain's cone."""
    _needs(2)
    x = _u((16, 24, 130), seed=2)
    shift = np.array([[0, 0, 0], [1, 0, 0], [0, 2, 0]])
    stages = [(OFFS, WEIGHTS), (shift, [0.5, 0.25, 0.25])]
    kw = dict(tile=(4, 8, 64), sweep_axis=0)
    base = tst.stencil_iterate(x, stages=stages, **kw, **CPU)
    got = tst.stencil_iterate(x, stages=stages, num_shards=2, **kw, **CPU)
    want = jst.stencil_iterate(jnp.asarray(x), stages=stages, num_shards=2,
                               interpret=True, **kw)
    _equal(got, base, want)


def test_planner_driven_sharded_launch(memory_planner):
    """No tile: the sharded plan (slab tile, shard axis) drives the
    launch; the same plan at one shard is the reference, and the JAX
    launch at the port's plan runs sharded too."""
    _needs(2)
    x = _u((32, 48, 130), seed=3)
    plan = memory_planner.plan(shape=x.shape, offsets=OFFS,
                               vmem_budget=1 << 20, num_shards=2)
    assert plan.num_shards == 2 and plan.shard_axis is not None
    assert plan.shard_axis != plan.sweep_axis
    got = tst.stencil_pallas(x, OFFS, WEIGHTS, plan=plan, **CPU)
    base = tst.stencil_pallas(x, OFFS, WEIGHTS, plan=plan, num_shards=1,
                              **CPU)
    want = jst.stencil_pallas(jnp.asarray(x), OFFS, WEIGHTS,
                              plan=_ref_plan(plan), interpret=True)
    _equal(got, base, want)
    # The frontend without a tile asks the planner for the same plan.
    planned = tst.stencil_pallas(x, OFFS, WEIGHTS, vmem_budget=1 << 20,
                                 num_shards=2, **CPU)
    _equal(planned, got)


def test_explicit_mesh_matches_num_shards():
    _needs(2)
    x = _u((16, 24, 130), seed=4)
    kw = dict(tile=(4, 8, 64), sweep_axis=0)
    mesh = make_column_mesh(2, device="cpu")
    assert mesh.size == 2 and mesh.axis_names == ("columns",)
    a = tst.stencil_pallas(x, OFFS, WEIGHTS, mesh=mesh, **kw, **CPU)
    b = tst.stencil_pallas(x, OFFS, WEIGHTS, num_shards=2, **kw, **CPU)
    want = jst.stencil_pallas(jnp.asarray(x), OFFS, WEIGHTS,
                              mesh=jax.make_mesh((2,), ("columns",)),
                              interpret=True, **kw)
    _equal(a, b, want)


def test_more_shards_than_columns():
    """Two columns on axis 1 over 4 shards: the surplus shards compute
    slack that the gather drops, exactly."""
    _needs(4)
    x = _u((16, 24, 130), seed=5)
    kw = dict(tile=(4, 16, 64), sweep_axis=0)
    base = tst.stencil_pallas(x, OFFS, WEIGHTS, **kw, **CPU)
    got = tst.stencil_pallas(x, OFFS, WEIGHTS, num_shards=4, shard_axis=1,
                             **kw, **CPU)
    want = jst.stencil_pallas(jnp.asarray(x), OFFS, WEIGHTS, num_shards=4,
                              shard_axis=1, interpret=True, **kw)
    _equal(got, base, want)


def test_one_shard_is_the_single_device_path(monkeypatch):
    """num_shards=1 never builds a mesh."""
    x = _u((16, 24, 130), seed=6)
    kw = dict(tile=(4, 8, 64), sweep_axis=0)
    a = tst.stencil_pallas(x, OFFS, WEIGHTS, **kw, **CPU)

    def no_mesh(*a_, **kw_):
        raise AssertionError("a 1-shard call built a mesh")

    monkeypatch.setattr(tsc, "make_column_mesh", no_mesh)
    b = tst.stencil_pallas(x, OFFS, WEIGHTS, num_shards=1, **kw, **CPU)
    want = jst.stencil_pallas(jnp.asarray(x), OFFS, WEIGHTS, num_shards=1,
                              interpret=True, **kw)
    _equal(a, b, want)


@pytest.mark.parametrize("pin", ["shard_axis", "sweep_axis"])
def test_explicit_axis_pin_survives_planner_collision(pin):
    """Pinning one of the two axes without a tile: when the planner's
    choice of the other collides with the pin, the pin wins and the free
    axis is derived again — the call runs and equals the unsharded
    call."""
    _needs(2)
    x = _u((64, 24, 16), seed=8)
    pinned = {"shard_axis": dict(shard_axis=1),
              "sweep_axis": dict(sweep_axis=0)}[pin]
    base = tst.stencil_pallas(x, OFFS, WEIGHTS, vmem_budget=1 << 20, **CPU)
    got = tst.stencil_pallas(x, OFFS, WEIGHTS, vmem_budget=1 << 20,
                             num_shards=2, **pinned, **CPU)
    want = jst.stencil_pallas(jnp.asarray(x), OFFS, WEIGHTS,
                              vmem_budget=1 << 20, num_shards=2,
                              interpret=True, **pinned)
    _equal(got, base, want)


def test_unshardable_grid_rejected_upfront(memory_planner):
    """A grid with fewer than 2 non-unit dims has no (shard, sweep) pair:
    refused with the reference's error, not a budget one."""
    for planner in (memory_planner,
                    jplan.Planner(cache=jplan.PlanCache(persistent=False))):
        with pytest.raises(ValueError, match="cross axis"):
            planner.plan(shape=(1024, 1),
                         offsets=np.array([[-1, 0], [0, 0], [1, 0]]),
                         num_shards=2)


def test_mesh_axis_name_shares_cache_key():
    offs = np.array([[-1, 0], [0, 0], [0, 1]])
    a = PlanRequest.make(shape=(64, 64), offsets=offs, num_shards=2)
    b = PlanRequest.make(shape=(64, 64), offsets=offs, num_shards=2,
                         mesh_axis="x")
    assert a.cache_key() == b.cache_key()


def test_shard_axis_validation():
    x = _u((16, 24, 130), seed=7)
    for frontend, kw in ((tst.stencil_pallas, CPU),
                         (jst.stencil_pallas, dict(interpret=True))):
        with pytest.raises(ValueError, match="sweep axis"):
            frontend(x, OFFS, WEIGHTS, tile=(4, 8, 64), sweep_axis=1,
                     shard_axis=1, num_shards=2, **kw)
        with pytest.raises(ValueError, match="out of range"):
            frontend(x, OFFS, WEIGHTS, tile=(4, 8, 64), sweep_axis=0,
                     shard_axis=5, num_shards=2, **kw)


def test_1d_grid_cannot_shard():
    offs = np.array([[-1], [0], [1]])
    with pytest.raises(ValueError, match="cross axis"):
        tst.stencil_pallas(np.ones(128, np.float32), offs, [1.0] * 3,
                           num_shards=2, **CPU)
    with pytest.raises(ValueError, match="cross axis"):
        tst.stencil_pallas(np.ones(128, np.float32), offs, [1.0] * 3,
                           tile=(8,), sweep_axis=0, num_shards=2, **CPU)


def test_pick_shard_axis_prefers_most_columns():
    for pick in (tsc.pick_shard_axis, jsc.pick_shard_axis):
        assert pick((16, 24, 130), (4, 8, 64), 0) == 1
        assert pick((16, 64, 130), (4, 8, 64), 0) == 1
        assert pick((16, 8, 512), (4, 8, 64), 0) == 2
        with pytest.raises(ValueError, match="cross axis"):
            pick((128,), (4,), 0)


def test_plan_v4_shard_fields():
    """A reference v4 plan with shard fields, as JSON, loads through the
    port's ``StencilPlan.from_dict`` and, passed as ``plan=`` on a CPU mesh
    of its size, runs sharded: equal to the JAX sharded launch at that
    plan and to the port's unsharded launch."""
    _needs(4)
    jplanner = jplan.Planner(cache=jplan.PlanCache(persistent=False))
    x = _u((16, 40, 128), seed=9)
    ref = jplanner.plan(shape=x.shape, offsets=OFFS, vmem_budget=1 << 20,
                        num_shards=4)
    assert ref.num_shards == 4 and ref.shard_axis is not None
    plan = StencilPlan.from_dict(json.loads(ref.to_json()))
    assert (plan.num_shards, plan.shard_axis, plan.halo_exchange_bytes,
            plan.per_shard_traffic_bytes) == (
        ref.num_shards, ref.shard_axis, ref.halo_exchange_bytes,
        ref.per_shard_traffic_bytes)
    mesh = make_column_mesh(4, device="cpu")
    got = tst.stencil_pallas(x, OFFS, WEIGHTS, plan=plan, mesh=mesh, **CPU)
    base = tst.stencil_pallas(x, OFFS, WEIGHTS, plan=plan, num_shards=1,
                              **CPU)
    want = jst.stencil_pallas(jnp.asarray(x), OFFS, WEIGHTS, plan=ref,
                              interpret=True)
    _equal(got, base, want)


# -- tests/test_ring_windows.py, test_boundary_menu.py, test_ir.py ------------


def test_ring_sharded_bitwise_vs_single_device():
    _needs(4)
    x = _u((32, 48), seed=10)
    offs = star_stencil(2, 1)
    w = np.linspace(-0.25, 0.3, len(offs)).tolist()
    kw = dict(tile=(8, 16), sweep_axis=0, window_kind="ring")
    base = tst.stencil_iterate(x, offs, w, 3, **kw, **CPU)
    got = tst.stencil_iterate(x, offs, w, 3, num_shards=4, shard_axis=1,
                              **kw, **CPU)
    want = jst.stencil_iterate(jnp.asarray(x), offs, w, 3, num_shards=4,
                               shard_axis=1, interpret=True, **kw)
    _equal(got, base, want)


STAR2 = np.array([(0, 0), (-1, 0), (1, 0), (0, -1), (0, 2)])
STAR2_W = [0.3, 0.2, 0.15, 0.1, 0.05]
KINDS = [("periodic", 0.0), ("robin", (0.8, -0.2)), ("dirichlet", 0.5),
         ("neumann", 0.0), ("reflect", 0.0)]


@pytest.mark.parametrize("kind,value", KINDS, ids=[k for k, _ in KINDS])
@pytest.mark.parametrize("shape", [(64, 256), (64, 192)])
def test_boundary_sharded_bitwise_parity(kind, value, shape):
    """Every boundary kind over 4 shards; (64, 192) leaves the last
    shard ragged (3 of 4 own rows), and under periodic wrap the links
    close the ring over the shards that own rows."""
    _needs(4)
    x = _u(shape, seed=17)
    kw = dict(tile=(64, 64), sweep_axis=0)
    # Reflect takes a symmetric halo (ir.verify): the 5-point star.
    op = (star_stencil(2, 1), STAR2_W) if kind == "reflect" \
        else (STAR2, STAR2_W)
    tprog = tir.chain_program([op] * 2, 2, boundary=kind, value=value)
    jprog = jir.chain_program([op] * 2, 2, boundary=kind, value=value)
    base = tir.run_program(tprog, x, **kw, **CPU)
    got = tir.run_program(tprog, x, num_shards=4, **kw, **CPU)
    want = jir.run_program(jprog, jnp.asarray(x), num_shards=4,
                           interpret=True, **kw)
    _equal(got, base, want)


def test_periodic_wrap_spanning_two_shards_is_refused():
    """A trailing shard with fewer true rows than the wrap band: the
    reference's error."""
    x = _u((64, 130), seed=18)
    prog = tir.chain_program([(STAR2, STAR2_W)] * 2, 2, boundary="periodic")
    with pytest.raises(ValueError, match="more than one"):
        tir.run_program(prog, x, tile=(8, 64), sweep_axis=0, num_shards=3,
                        shard_axis=1, **CPU)


def test_neumann_program_on_mesh():
    _needs(4)
    o1 = star_stencil(2, 1)
    w1 = tuple(np.linspace(-0.3, 0.4, len(o1)).tolist())
    x = _u((41, 52), seed=19)
    kw = dict(tile=(8, 16), sweep_axis=0)
    tprog = tir.chain_program([(o1, w1)] * 2, 2, boundary="neumann")
    jprog = jir.chain_program([(o1, w1)] * 2, 2, boundary="neumann")
    base = tir.run_program(tprog, x, **kw, **CPU)
    got = tir.run_program(tprog, x, num_shards=4, **kw, **CPU)
    want = jir.run_program(jprog, jnp.asarray(x), num_shards=4,
                           interpret=True, **kw)
    _equal(got, base, want)


# -- the int8 zero point at the mesh edges --------------------------------------


def _spec(o, w):
    return (tuple(map(tuple, np.asarray(o).tolist())),
            tuple(float(v) for v in w))


def test_int8_codes_with_a_zero_point_shard_as_one_launch():
    """int8 codes with zero point 3 into a one-stage chain over 2 shards
    on axis 1.  The port's mesh-edge halos hold the zero point, as the
    single-device pad does: sharded equals unsharded and the JAX
    single-device launch.  The JAX sharded launch reads code 0 there
    (``ppermute``'s fill, −3·0.05 after dequantizing) and differs on the
    edge rows of the shard axis."""
    _needs(2)
    q = (0.05, 3)
    codes = np.random.default_rng(20).integers(
        -100, 100, (8, 16, 64)).astype(np.int8)
    sw = (_spec(OFFS, WEIGHTS),)
    kw = dict(stages_w=sw, dtypes_w=("float32",), in_quant=q)
    tile = (4, 4, 64)
    t_in = (torch.as_tensor(codes),)
    base = tst._stencil_call(t_in, sw, tile, 0, True, **kw)
    got = tsc.sharded_stencil_call(t_in, sw, tile, 0, True, num_shards=2,
                                   shard_axis=1, **kw)
    j_in = (jnp.asarray(codes),)
    j_single = jst._stencil_call(j_in, sw, tile, 0, True, True, **kw)
    j_sharded = jsc.sharded_stencil_call(j_in, sw, tile, 0, True, True,
                                         num_shards=2, shard_axis=1, **kw)
    _equal(got, base, j_single)
    diff = np.asarray(j_sharded) != np.asarray(j_single)
    assert diff.any(), "the JAX sharded launch no longer differs here"
    rows = sorted(set(np.nonzero(diff)[1].tolist()))
    assert rows == [0, 15], rows  # the mesh edges of the shard axis


def test_planned_int8_chain_hands_codes_across_sharded_launches(
        memory_planner):
    """A quantized chain split into one launch a stage hands int8 codes
    (zero point 3) from launch to launch; sharded it equals the unsharded
    call and the JAX single-device launch at the same plan."""
    _needs(2)
    q = (1 / 64, 3)
    x = _u((8, 16, 64), seed=21)
    kw = dict(boundary="reflect", quants=[q, q, None])
    tprog = tir.chain_program([(OFFS, WEIGHTS)] * 3, 3, **kw)
    jprog = jir.chain_program([(OFFS, WEIGHTS)] * 3, 3, **kw)
    tile = (4, 4, 64)
    base = tir.run_program(tprog, x, tile=tile, sweep_axis=0, **CPU)
    req = dict(shape=x.shape, stages=[OFFS] * 3, bcs=(("reflect", 0.0),) * 3,
               dtypes=("int8", "int8", None), num_shards=2)
    plan = next(p for p in memory_planner.candidates(k=8, **req)
                if p.fused_depth == 1)
    got = tir.run_program(tprog, x, plan=plan, **CPU)
    single = tir.run_program(tprog, x, plan=plan, num_shards=1, **CPU)
    want = jir.run_program(jprog, jnp.asarray(x), plan=_ref_plan(plan),
                           num_shards=1, interpret=True)
    _equal(got, single, want)
    _equal(single, base)


# -- the exchange counters --------------------------------------------------------


def test_exchange_counters_equal_jax_and_the_plan(memory_planner, tmp_path):
    """``halo_exchange_bytes``/``_rounds`` of a port trace equal the JAX
    package's for the same call at the same plan, and the plan's
    ``halo_exchange_bytes``; one ``halo_exchange`` span a launch."""
    _needs(2)
    from repro_torch.obs.report import reconcile, summarize

    x = _u((16, 40, 130), seed=22)
    plan = next(p for p in memory_planner.candidates(
        k=8, shape=x.shape, offsets=OFFS, time_steps=3, num_shards=2,
        vmem_budget=1 << 20) if p.fused_depth == 1)
    with obs.recording() as rec:
        got = tst.stencil_iterate(x, OFFS, WEIGHTS, 3, plan=plan, **CPU)
    with jobs.recording() as jrec:
        want = jst.stencil_iterate(jnp.asarray(x), OFFS, WEIGHTS, 3,
                                   plan=_ref_plan(plan), interpret=True)
    _equal(got, want)
    for name in ("halo_exchange_bytes", "halo_exchange_rounds"):
        assert rec.counters[name] == jrec.counters[name] > 0, name
    assert rec.counters["halo_exchange_bytes"] == plan.halo_exchange_bytes
    spans = [s for s in rec.spans if s.name == "halo_exchange"]
    assert len(spans) == rec.counters["launches"] == 3
    path = rec.write(str(tmp_path / "t.json"))
    summ = summarize(obs.load_trace(path))
    assert reconcile(summ) == [] and summ["n_exchange_spans"] == 3
    assert {ln["num_shards"] for ln in summ["launches"]} == {2}


# -- the mesh --------------------------------------------------------------------


def test_a_mesh_never_co_locates_shards_on_its_own(monkeypatch):
    """``num_shards=2`` without a mesh asks ``make_column_mesh`` for 2
    devices of the input's kind, which on a machine with one card raises
    ``RuntimeError``; shards share a card only when the mesh names it for
    each."""
    asked = []
    real = tsc.make_column_mesh

    def spy(n, **kw):
        asked.append((n, kw))
        return real(n, **kw)

    monkeypatch.setattr(tsc, "make_column_mesh", spy)
    x = _u((16, 24, 130))
    tst.stencil_pallas(x, OFFS, WEIGHTS, tile=(4, 8, 64), sweep_axis=0,
                       num_shards=2, **CPU)
    assert asked == [(2, {"device": "cpu"})]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 devices, found 1"):
        make_column_mesh(2)
    with pytest.raises(RuntimeError, match="needs 2 devices, found 1"):
        make_column_mesh(2, devices=["cuda:0"])
    mesh = make_column_mesh(2, devices=["cuda:0"] * 2)
    assert mesh.devices == (torch.device("cuda", 0),) * 2


def test_mesh_refusals():
    with pytest.raises(ValueError, match=">= 1"):
        make_column_mesh(0, device="cpu")
    x = _u((16, 24, 130))
    kw = dict(tile=(4, 8, 64), sweep_axis=0, **CPU)
    with pytest.raises(TypeError, match="one-axis mesh"):
        tst.stencil_pallas(x, OFFS, WEIGHTS, mesh=object(), **kw)
    with pytest.raises(TypeError, match="one-axis mesh"):
        tst.stencil_pallas(x, OFFS, WEIGHTS,
                           mesh=make_test_mesh(device="cpu"), **kw)
    with pytest.raises(ValueError, match="contradicts"):
        tst.stencil_pallas(x, OFFS, WEIGHTS, num_shards=3,
                           mesh=make_column_mesh(2, device="cpu"), **kw)
    mesh = make_column_mesh(3, device="cpu")
    assert isinstance(mesh, ModelMesh) and mesh.shape == {"columns": 3}


@pytest.mark.cuda
def test_two_card_mesh_equals_one_card():
    """A mesh over two cards: every cross-card copy is ordered against
    both cards' streams, and the result equals the unsharded launch."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    x = torch.as_tensor(_u((64, 96, 128), seed=23), device="cuda:0")
    mesh = make_column_mesh(2)
    for call in (
        lambda **kw: tst.stencil_pallas(x, OFFS, WEIGHTS, tile=(8, 16, 32),
                                        sweep_axis=0, **kw),
        lambda **kw: tst.stencil_iterate(x, OFFS, WEIGHTS, 3,
                                         tile=(8, 16, 32), sweep_axis=0,
                                         **kw),
    ):
        base = call()
        got = call(mesh=mesh)
        torch.cuda.synchronize()
        assert got.device == x.device
        assert torch.equal(got, base)


def test_shard_axis_extent_not_divisible_by_the_shards():
    """130 rows over 4 shards along axis 2: the port runs it and equals
    its unsharded launch and the JAX single-device launch; the JAX sharded
    launch raises ``ShardingTypeError`` in its final trim (the image's jax
    refuses to slice a sharded axis to an extent the mesh does not
    divide)."""
    _needs(4)
    x = _u((16, 24, 130), seed=24)
    kw = dict(tile=(4, 8, 64), sweep_axis=0)
    base = tst.stencil_pallas(x, OFFS, WEIGHTS, **kw, **CPU)
    got = tst.stencil_pallas(x, OFFS, WEIGHTS, num_shards=4, shard_axis=2,
                             **kw, **CPU)
    want = jst.stencil_pallas(jnp.asarray(x), OFFS, WEIGHTS, interpret=True,
                              **kw)
    _equal(got, base, want)
    with pytest.raises(Exception, match="not divisible"):
        jst.stencil_pallas(jnp.asarray(x), OFFS, WEIGHTS, num_shards=4,
                           shard_axis=2, interpret=True, **kw)


@pytest.mark.cuda
def test_co_located_mesh_on_one_card_equals_unsharded():
    """Four shards named on one card: the slab launches run in order on
    its stream and equal the unsharded launch, the int8 zero-point case
    included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_column_mesh(4, devices=[dev] * 4)
    x = torch.as_tensor(_u((64, 96, 128), seed=25), device=dev)
    kw = dict(tile=(8, 16, 32), sweep_axis=0)
    prog = tir.chain_program([(OFFS, WEIGHTS)] * 3, 3, boundary="periodic")
    for call in (
        lambda **k: tst.stencil_pallas(x, OFFS, WEIGHTS, **kw, **k),
        lambda **k: tst.stencil_iterate(x, OFFS, WEIGHTS, 3, **kw, **k),
        lambda **k: tir.run_program(prog, x, **kw, **k),
    ):
        assert torch.equal(call(mesh=mesh), call())
    codes = torch.randint(-100, 100, (8, 16, 64), dtype=torch.int8,
                          device=dev)
    sw = (_spec(OFFS, WEIGHTS),)
    ikw = dict(stages_w=sw, dtypes_w=("float32",), in_quant=(0.05, 3))
    base = tst._stencil_call((codes,), sw, (4, 4, 64), 0, True, **ikw)
    got = tsc.sharded_stencil_call((codes,), sw, (4, 4, 64), 0, True,
                                   shard_axis=1, mesh=make_column_mesh(
                                       2, devices=[dev] * 2), **ikw)
    assert torch.equal(got, base)
