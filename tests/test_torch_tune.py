"""The port's measured tune loop on the CPU (``device="cpu"``: the race
times the kernels' plain versions).

* The cases of ``tests/test_tune.py`` on the port: candidate enumeration,
  the tune pass and its never-slower gate, the planner's preference for
  a measured winner, ``TunedPlanDB`` robustness (corrupt, stale-schema,
  stale-planner, foreign-fingerprint and advisory-winner entries; an
  unwritable directory), the window/dtype variant race, the
  ``stencil_*(tune=...)`` plumbing and the timing harness.  The sharded
  case asserts ``NotImplementedError`` until ``ROADMAP.md`` queue A item
  11 (column sharding).
* ``_median_iqr`` and ``_spearman`` equal the JAX package's on seeded
  numpy inputs; a ``TuneRecord`` round-trips through JSON; a CPU record
  is never served to a ``cuda:`` fingerprint.
* ``stencil_pallas(tune=...)`` on the CPU equals the JAX launch of the
  same program at the winner's plan exactly.
* The frontend's memo of planned calls never hides a measured winner:
  a planner with a tuned DB plans each call, and ``tune=`` routes through
  the tuner, not through the memo.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import plan as jplan  # noqa: E402
from repro.kernels import stencil as jst  # noqa: E402
from repro.plan.tune import _spearman as j_spearman  # noqa: E402
from repro.runtime.timing import _median_iqr as j_median_iqr  # noqa: E402
from repro_torch.core.cache_fitting import star_stencil  # noqa: E402
from repro_torch.kernels import stencil as tst  # noqa: E402
from repro_torch.kernels.ref import stencil_ref  # noqa: E402
from repro_torch.plan import (  # noqa: E402
    TUNEDB_SCHEMA,
    AutoTuner,
    PlanCache,
    Planner,
    PlanRequest,
    StencilPlan,
    TunedPlanDB,
    TuneRecord,
    planner as planner_mod,
    resolve_tuner,
    tune as tune_mod,
)
from repro_torch.plan.tune import (  # noqa: E402
    _spearman,
    backend_fingerprint,
    format_record,
)
from repro_torch.runtime.timing import (  # noqa: E402
    _median_iqr,
    device_fingerprint,
    measure,
)

O7 = star_stencil(3, 1)
W7 = [1.0 / 7] * 7

KW = dict(shape=(12, 16, 32), offsets=O7, vmem_budget=32 * 1024,
          aligned=True)
CHAIN_KW = dict(shape=(32, 128), offsets=star_stencil(2, 1), time_steps=3,
                vmem_budget=16 * 1024, aligned=True)


def _request(**over):
    kw = dict(KW)
    kw.update(over)
    return PlanRequest.make(**kw)


def _chain_request(**over):
    kw = dict(CHAIN_KW)
    kw.update(over)
    return PlanRequest.make(**kw)


def _tuner(db=None, **kw):
    kw.setdefault("k", 2)
    kw.setdefault("reps", 2)
    kw.setdefault("warmup", 1)
    kw.setdefault("device", "cpu")
    return AutoTuner(
        db=db if db is not None else TunedPlanDB(persistent=False),
        planner=Planner(cache=PlanCache(persistent=False)),
        **kw,
    )


@pytest.fixture(scope="module")
def tuned():
    """One real tune pass shared by every test that only needs a record."""
    db = TunedPlanDB(persistent=False)
    tuner = _tuner(db)
    rec = tuner.tune(_request())
    return db, tuner, rec


@pytest.fixture(scope="module")
def tuned_chain():
    """One chain tune pass: races geometry + window flip + the advisory
    bf16/int8 storage variants."""
    db = TunedPlanDB(persistent=False)
    tuner = _tuner(db)
    rec = tuner.tune(_chain_request())
    return db, tuner, rec


@pytest.fixture
def memory_defaults(monkeypatch, tmp_path):
    """The frontends' default planner memory-only and the default tuners'
    DB in a temporary directory: nothing lands in ~."""
    p = Planner(cache=PlanCache(persistent=False))
    monkeypatch.setattr(planner_mod, "_DEFAULT", p)
    monkeypatch.setattr(tune_mod, "_DEFAULT", {})
    monkeypatch.setenv("REPRO_TORCH_TUNED_DB_DIR", str(tmp_path / "tuned"))
    return p


# -- Planner.candidates ------------------------------------------------------


def test_candidates_analytic_first():
    planner = Planner(cache=PlanCache(persistent=False))
    req = _request()
    cands = planner.candidates(req, k=4)
    assert 1 <= len(cands) <= 4
    assert all(isinstance(c, StencilPlan) for c in cands)
    assert cands[0] == planner.plan(req)
    assert all(c.request == req for c in cands)
    # ranked by the port's score, modelled time
    assert [c.modeled_ms for c in cands[1:]] == \
        sorted(c.modeled_ms for c in cands[1:])


def test_candidates_distinct_launch_signatures():
    planner = Planner(cache=PlanCache(persistent=False))
    cands = planner.candidates(_request(), k=8)
    sigs = [
        (c.tile, c.sweep_axis, c.fused_depth, c.shard_axis) for c in cands
    ]
    assert len(sigs) == len(set(sigs)), "duplicate launch signature raced"


def test_candidates_k1_is_the_plan():
    planner = Planner(cache=PlanCache(persistent=False))
    req = _request()
    assert planner.candidates(req, k=1) == [planner.plan(req)]


# -- the tune pass -----------------------------------------------------------


def test_tune_never_slower_and_record_roundtrip(tuned):
    _, _, rec = tuned
    assert rec.never_slower
    assert rec.analytic == 0
    assert 0 <= rec.winner < len(rec.candidates)
    assert rec.speedup_vs_analytic >= 1.0
    assert rec.key == _request().cache_key()
    assert rec.fingerprint == backend_fingerprint("cpu")
    assert all(c.median_s > 0 and c.reps == 2 for c in rec.candidates)
    assert all(c.modeled_ms > 0 for c in rec.candidates)
    # The analytic candidate's ratio is 1 by definition of the baseline.
    assert rec.candidates[0].model_measured_ratio == pytest.approx(1.0)
    assert TuneRecord.from_dict(rec.to_dict()) == rec
    assert TuneRecord.from_dict(
        json.loads(json.dumps(rec.to_dict()))
    ) == rec


def test_rank_correlation_is_against_modelled_time(tuned):
    _, _, rec = tuned
    assert rec.rank_correlation == _spearman(
        [c.modeled_ms for c in rec.candidates],
        [c.median_s for c in rec.candidates])
    base = rec.candidates[0]
    for c in rec.candidates:
        assert c.model_measured_ratio == pytest.approx(
            (c.modeled_ms / base.modeled_ms) / (c.median_s / base.median_s))


def test_planner_prefers_measured_winner_without_remeasuring(tuned):
    db, _, rec = tuned
    planner = Planner(cache=PlanCache(persistent=False), tuned_db=db,
                      device="cpu")
    misses_before = db.stats["misses"]
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        served = planner.plan(_request())
        warm.append(time.perf_counter() - t0)
        assert planner.last_plan_tuned
        assert served == rec.winner_plan
    assert db.stats["misses"] == misses_before, "warm hit re-measured"
    assert min(warm) < 0.05


def test_planner_miss_falls_back_to_analytic_unchanged():
    db = TunedPlanDB(persistent=False)        # empty: every get misses
    with_db = Planner(cache=PlanCache(persistent=False), tuned_db=db,
                      device="cpu")
    plain = Planner(cache=PlanCache(persistent=False))
    req = _request()
    assert with_db.plan(req) == plain.plan(req)
    assert not with_db.last_plan_tuned
    assert db.stats["misses"] == 1


def test_autotuner_plan_warm_vs_fresh(tuned):
    db, tuner, rec = tuned
    assert tuner.plan(_request()) == rec.winner_plan
    assert tuner.last_plan_tuned        # served from the DB, not re-raced
    force = _tuner(db, force=True)
    assert force.plan(_request()) is not None
    assert not force.last_plan_tuned    # force=True re-measures


# -- TunedPlanDB robustness --------------------------------------------------


def _store(tmp_path, rec):
    db = TunedPlanDB(db_dir=str(tmp_path))
    db.put(rec)
    path = db._path(rec.key, rec.fingerprint)
    assert os.path.exists(path)
    return path


def test_db_has_its_own_directory(monkeypatch, tmp_path):
    from repro_torch.plan.tunedb import default_tuned_db_dir

    monkeypatch.delenv("REPRO_TORCH_TUNED_DB_DIR", raising=False)
    monkeypatch.setenv("REPRO_TUNED_DB_DIR", str(tmp_path / "jax"))
    assert default_tuned_db_dir().endswith(
        os.path.join(".cache", "repro_torch", "tuned"))
    monkeypatch.setenv("REPRO_TORCH_TUNED_DB_DIR", str(tmp_path / "mine"))
    assert default_tuned_db_dir() == str(tmp_path / "mine")


def test_disk_roundtrip(tmp_path, tuned):
    _, _, rec = tuned
    _store(tmp_path, rec)
    cold = TunedPlanDB(db_dir=str(tmp_path))
    assert cold.get(rec.key, rec.fingerprint) == rec
    assert cold.stats["disk_hits"] == 1


def test_corrupt_entry_dropped_and_retuned(tmp_path, tuned):
    _, _, rec = tuned
    path = _store(tmp_path, rec)
    with open(path, "w") as f:
        f.write("{not json")
    cold = TunedPlanDB(db_dir=str(tmp_path))
    assert cold.get(rec.key, rec.fingerprint) is None
    assert cold.stats["corrupt"] == 1
    assert not os.path.exists(path)          # poisoned entry dropped
    # ... and the autotuner heals it with a fresh measurement.
    tuner = _tuner(cold)
    assert tuner.plan(_request()) is not None
    assert not tuner.last_plan_tuned         # tuned fresh, not served stale
    assert cold.get(rec.key, rec.fingerprint) is not None


def test_schema_bump_invalidates(tmp_path, tuned):
    _, _, rec = tuned
    path = _store(tmp_path, rec)
    d = json.load(open(path))
    d["schema"] = TUNEDB_SCHEMA + 1
    json.dump(d, open(path, "w"))
    cold = TunedPlanDB(db_dir=str(tmp_path))
    assert cold.get(rec.key, rec.fingerprint) is None
    assert cold.stats["stale_schema"] == 1
    assert cold.stats["corrupt"] == 1
    assert not os.path.exists(path)          # stale layout never re-read


def test_planner_version_bump_invalidates(tmp_path, tuned):
    _, _, rec = tuned
    path = _store(tmp_path, rec)
    d = json.load(open(path))
    d["planner_version"] += 1
    json.dump(d, open(path, "w"))
    cold = TunedPlanDB(db_dir=str(tmp_path))
    assert cold.get(rec.key, rec.fingerprint) is None
    assert cold.stats["stale_schema"] == 1
    assert not os.path.exists(path)


def test_fingerprint_mismatch_never_served(tmp_path, tuned):
    """A record taken on another backend is a clean miss: never served,
    never deleted (it still answers for the backend that wrote it)."""
    _, _, rec = tuned
    path = _store(tmp_path, rec)
    other = rec.fingerprint + "|other-backend"
    cold = TunedPlanDB(db_dir=str(tmp_path))
    assert cold.get(rec.key, other) is None
    assert cold.stats["corrupt"] == 0
    # A file under the requested tag that records another fingerprint
    # inside (copied caches) — content wins over filename.
    shutil.copy(path, cold._path(rec.key, other))
    assert cold.get(rec.key, other) is None
    assert cold.stats["fingerprint_misses"] == 1
    assert cold.stats["corrupt"] == 0
    assert os.path.exists(path)              # original entry preserved
    assert cold.get(rec.key, rec.fingerprint) == rec


def test_cpu_record_never_served_to_the_card(tmp_path, tuned):
    """The CPU's measurement of the plain versions under a ``cuda:``
    fingerprint — what a card process asks for — is a miss, whichever
    file it sits in; and the fingerprint names the kernels' sources."""
    _, _, rec = tuned
    assert rec.fingerprint.startswith("cpu:")
    kernels = rec.fingerprint.split("|kernels=")[1]
    assert len(kernels) == 16
    card = (f"cuda:NVIDIA_H100_80GB_HBM3:x1:torch-{torch.__version__}:"
            f"cuda-12.8|kernels={kernels}")
    path = _store(tmp_path, rec)
    cold = TunedPlanDB(db_dir=str(tmp_path))
    assert cold.get(rec.key, card) is None
    shutil.copy(path, cold._path(rec.key, card))
    assert cold.get(rec.key, card) is None
    assert cold.stats["fingerprint_misses"] == 1
    planner = Planner(cache=PlanCache(persistent=False), tuned_db=cold,
                      device="cpu")
    assert planner.plan(_request()) == rec.winner_plan


def test_kernel_source_change_invalidates_records(monkeypatch, tuned):
    _, _, rec = tuned
    db, _, _ = tuned
    monkeypatch.setattr(tune_mod, "_KERNELS_HASH", ["0" * 16])
    fp = backend_fingerprint("cpu")
    assert fp != rec.fingerprint and fp.endswith("|kernels=" + "0" * 16)
    assert db.get(rec.key, fp) is None


def test_unwritable_dir_degrades_once(tuned, tmp_path, caplog):
    _, _, rec = tuned
    blocked = tmp_path / "a-file-not-a-dir"
    blocked.write_text("")
    db = TunedPlanDB(db_dir=str(blocked / "sub"))
    with caplog.at_level("WARNING", logger="repro_torch.plan.tunedb"):
        db.put(rec)
        db.put(rec)
    assert db.dir is None                    # degraded to memory-only
    assert db.stats["disk_errors"] == 1      # ... after exactly one error
    assert len(caplog.records) == 1          # ... and exactly one warning
    assert db.get(rec.key, rec.fingerprint) == rec   # memory still serves


# -- the variant race + TUNEDB_SCHEMA v2 ------------------------------------


def test_chain_race_covers_windows_and_dtypes(tuned_chain):
    _, _, rec = tuned_chain
    assert {c.window_kind for c in rec.candidates} >= {"ring", "trapezoid"}
    named = {
        dt for c in rec.candidates if c.stage_dtypes
        for dt in c.stage_dtypes if dt is not None
    }
    assert named == {"bfloat16", "int8"}
    assert all(c.advisory == bool(c.stage_dtypes) for c in rec.candidates)
    assert rec.analytic == 0
    assert rec.candidates[0].stage_dtypes is None
    assert not rec.candidates[rec.winner].advisory
    assert rec.never_slower
    assert rec.winner_plan.request.cache_key() == rec.key


def test_schema_v2_round_trip_with_variant_fields(tuned_chain):
    _, _, rec = tuned_chain
    assert rec.schema == TUNEDB_SCHEMA == 2
    assert TuneRecord.from_dict(rec.to_dict()) == rec
    back = TuneRecord.from_dict(json.loads(json.dumps(rec.to_dict())))
    assert back == rec
    int8_rows = [
        c for c in back.candidates
        if c.stage_dtypes and "int8" in c.stage_dtypes
    ]
    assert int8_rows and int8_rows[0].advisory
    assert int8_rows[0].stage_dtypes == ("int8", "int8", None)


def test_v1_stale_entry_dropped_and_retuned(tmp_path, tuned_chain):
    _, _, rec = tuned_chain
    path = _store(tmp_path, rec)
    d = json.load(open(path))
    d["schema"] = 1
    for c in d["candidates"]:   # v1 rows predate the variant columns
        c.pop("window_kind"), c.pop("stage_dtypes"), c.pop("advisory")
    json.dump(d, open(path, "w"))
    cold = TunedPlanDB(db_dir=str(tmp_path))
    assert cold.get(rec.key, rec.fingerprint) is None
    assert cold.stats["stale_schema"] == 1
    assert not os.path.exists(path)
    tuner = _tuner(cold)
    assert tuner.plan(_chain_request()) is not None
    assert not tuner.last_plan_tuned     # healed by a fresh measurement
    healed = cold.get(rec.key, rec.fingerprint)
    assert healed is not None and healed.schema == TUNEDB_SCHEMA


def test_advisory_winner_record_rejected(tmp_path, tuned_chain):
    _, _, rec = tuned_chain
    path = _store(tmp_path, rec)
    d = json.load(open(path))
    advisory = [i for i, c in enumerate(d["candidates"]) if c["advisory"]]
    assert advisory, "chain tune raced no advisory rows"
    d["winner"] = advisory[0]
    json.dump(d, open(path, "w"))
    cold = TunedPlanDB(db_dir=str(tmp_path))
    assert cold.get(rec.key, rec.fingerprint) is None
    assert cold.stats["corrupt"] == 1
    assert not os.path.exists(path)


def test_variant_record_fingerprint_mismatch_is_clean_miss(tmp_path,
                                                           tuned_chain):
    _, _, rec = tuned_chain
    _store(tmp_path, rec)
    cold = TunedPlanDB(db_dir=str(tmp_path))
    assert cold.get(rec.key, rec.fingerprint + "|other") is None
    assert cold.stats["corrupt"] == 0
    assert cold.get(rec.key, rec.fingerprint) == rec


def test_pinned_window_kind_skips_the_flip():
    rec = _tuner().tune(_chain_request(window_kind="ring"))
    assert all(c.window_kind == "ring" for c in rec.candidates)


def test_dtyped_request_races_no_dtype_variants():
    rec = _tuner().tune(_chain_request(
        dtypes=["bfloat16", "bfloat16", "float32"],
    ))
    assert all(not c.advisory for c in rec.candidates)
    # The final "float32" restates the input dtype: None-normalized.
    assert all(
        c.stage_dtypes == ("bfloat16", "bfloat16", None)
        for c in rec.candidates
    )
    assert rec.never_slower


def test_int8_request_races_with_a_quantization():
    """An int8-stored request (the port refuses an int8 stage without a
    quantization) races its own rows, each launched with the race's
    quantization, and the winner runs the user's program."""
    q = (0.125, 1)
    prog_kw = dict(stages=[star_stencil(2, 1)] * 3, shape=(32, 128),
                   vmem_budget=16 * 1024, bcs=(("reflect", 0.0),) * 3,
                   dtypes=("int8", "int8", None))
    rec = _tuner().tune(**prog_kw)
    assert rec.never_slower
    assert all(not c.advisory and c.stage_dtypes == ("int8", "int8", None)
               for c in rec.candidates)
    from repro_torch import ir

    x = np.random.default_rng(2).standard_normal((32, 128)).astype(
        np.float32)
    prog = ir.chain_program([(star_stencil(2, 1), [0.2] * 5)] * 3, 2,
                            boundary="reflect", quants=[q, q, None])
    got = ir.run_program(prog, x, plan=rec.winner_plan, device="cpu")
    whole = ir.run_program(prog, x, tile=rec.winner_plan.tile,
                           sweep_axis=rec.winner_plan.sweep_axis,
                           device="cpu")
    assert torch.equal(got, whole)


# -- sharded tuning -------------------------------------------------------------


def test_sharded_request_tunes_sharded_launch(monkeypatch):
    """The reference's assertions on a CPU mesh: the race launches every
    candidate sharded on the mesh it is handed, and prices all shards
    plus the exchange; the winner run sharded equals its unsharded
    launch."""
    from repro_torch.launch.mesh import make_column_mesh
    from repro_torch.parallel import shard_columns

    mesh = make_column_mesh(2, device="cpu")
    seen = []
    real = shard_columns.sharded_stencil_call

    def spy(*a, **kw):
        seen.append(kw["mesh"])
        return real(*a, **kw)

    monkeypatch.setattr(shard_columns, "sharded_stencil_call", spy)
    tuner = _tuner()
    rec = tuner.tune(_request(num_shards=2), mesh=mesh)
    assert rec.never_slower
    assert rec.winner_plan.num_shards == 2
    assert all(c.shard_axis is not None for c in rec.candidates)
    assert seen and all(m is mesh for m in seen)
    w = rec.winner_plan
    assert rec.candidates[rec.winner].modeled_bytes == (
        w.per_shard_traffic_bytes * w.num_shards + w.halo_exchange_bytes
    )
    x = np.random.default_rng(4).standard_normal(KW["shape"]).astype(
        np.float32)
    got = tst.stencil_pallas(x, O7, W7, plan=w, mesh=mesh, device="cpu")
    base = tst.stencil_pallas(x, O7, W7, plan=w, num_shards=1, device="cpu")
    assert torch.equal(got, base)
    # tune=True on a sharded call hands the call's mesh to the race.
    seen.clear()
    again = tst.stencil_pallas(x, O7, W7, vmem_budget=KW["vmem_budget"],
                               mesh=mesh, tune=_tuner(), device="cpu")
    assert seen and all(m is mesh for m in seen)
    assert torch.equal(again, base)


def test_sharded_fingerprint_keys_on_the_mesh_layout():
    """A sharded race's record keys on which shards share a card: 4 shards
    on one card and 4 over 4 cards get different fingerprints, so neither
    record is served to the other's call; which cards does not matter
    (cards 4-7 read as 0-3); an unsharded fingerprint is unchanged."""
    from repro_torch.launch.mesh import ModelMesh, make_column_mesh
    from repro_torch.plan.tune import mesh_layout

    def column_mesh(devs):
        return ModelMesh(("columns",), (len(devs),), devs)

    cuda = [torch.device("cuda", i) for i in range(8)]
    co = column_mesh((cuda[0],) * 4)
    spread = column_mesh(tuple(cuda[:4]))
    other = column_mesh(tuple(cuda[4:]))
    pairs = column_mesh((cuda[0], cuda[0], cuda[1], cuda[1]))
    assert mesh_layout(co) == "0.0.0.0"
    assert mesh_layout(spread) == mesh_layout(other) == "0.1.2.3"
    assert mesh_layout(pairs) == "0.0.1.1"
    assert mesh_layout(None, 4) == "0.1.2.3"  # the mesh a launch builds
    assert mesh_layout(None, 1) is None
    assert mesh_layout(column_mesh((cuda[0],))) is None
    base = backend_fingerprint("cpu")
    assert base == (f"{device_fingerprint('cpu')}|kernels="
                    f"{tune_mod._kernels_hash()}")
    fps = {backend_fingerprint("cpu", mesh_layout(m))
           for m in (co, spread, pairs)}
    assert len(fps) == 3 and base not in fps
    # A race on two shards sharing the CPU is served to that layout only.
    tuner = _tuner()
    rec = tuner.tune(_request(num_shards=2),
                     mesh=make_column_mesh(2, device="cpu"))
    assert rec.fingerprint == backend_fingerprint("cpu", "0.0")
    assert tuner.db.get(rec.key, backend_fingerprint("cpu", "0.0")) == rec
    assert tuner.db.get(rec.key, backend_fingerprint("cpu", "0.1")) is None
    assert tuner.db.get(rec.key, base) is None


# -- kernel plumbing ----------------------------------------------------------


def test_stencil_pallas_tune_parity_and_warm_reuse():
    x = np.random.default_rng(0).standard_normal(KW["shape"]).astype(
        np.float32)
    tuner = _tuner()
    out = tst.stencil_pallas(x, O7, W7, vmem_budget=KW["vmem_budget"],
                             tune=tuner, device="cpu")
    assert not tuner.last_plan_tuned         # first call measured fresh
    ref = stencil_ref(torch.as_tensor(x), O7, W7)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    again = tst.stencil_pallas(x, O7, W7, vmem_budget=KW["vmem_budget"],
                               tune=tuner, device="cpu")
    assert tuner.last_plan_tuned             # second call: warm DB hit
    assert torch.equal(out, again)


@pytest.mark.parametrize("time_steps", [1, 3])
def test_tuned_call_equals_jax_at_the_winner(time_steps):
    """``tune=`` on the CPU equals the JAX launch (interpret mode) of the
    same program at the winner's plan, exactly."""
    shape = (12, 16, 32)
    x = np.random.default_rng(time_steps).standard_normal(shape).astype(
        np.float32)
    w = np.linspace(-0.3, 0.4, 7).tolist()
    tuner = _tuner(k=3)
    got = tst.stencil_iterate(x, O7, w, time_steps, vmem_budget=16 * 1024,
                              tune=tuner, device="cpu")
    winner = tuner.last_record.winner_plan
    ref_plan = jplan.StencilPlan.from_dict(json.loads(winner.to_json()))
    want = jst.stencil_iterate(jnp.asarray(x), O7, w, time_steps,
                               plan=ref_plan, interpret=True)
    assert np.array_equal(np.asarray(want), got.numpy())


def test_tune_true_uses_the_default_tuner_of_the_calls_device(
        memory_defaults, tmp_path):
    x = np.random.default_rng(1).standard_normal((8, 16, 32)).astype(
        np.float32)
    tst.stencil_pallas(x, O7, W7, vmem_budget=16 * 1024, tune=True,
                       device="cpu")
    tuner = resolve_tuner(True, "cpu")
    assert tuner.device == "cpu" and not tuner.last_plan_tuned
    # its DB is the one the environment names, on disk
    assert tuner.db.dir == str(tmp_path / "tuned")
    assert any(n.endswith(".json") for n in os.listdir(tuner.db.dir))
    tst.stencil_pallas(x, O7, W7, vmem_budget=16 * 1024, tune=True,
                       device="cpu")
    assert tuner.last_plan_tuned


@pytest.mark.parametrize("frontend", ["stencil_pallas", "stencil_iterate",
                                      "multi_stencil_pallas"])
@pytest.mark.parametrize("pin", ["tile", "plan"])
def test_tune_mutually_exclusive_with_pinned_decisions(frontend, pin):
    x = np.zeros((12, 16, 32), np.float32)
    tuner = _tuner()
    plan = Planner(cache=PlanCache(persistent=False)).plan(_request())
    pinned = {"tile": dict(tile=(4, 16, 32)), "plan": dict(plan=plan)}[pin]
    calls = {
        "stencil_pallas": lambda: tst.stencil_pallas(
            x, O7, W7, tune=tuner, device="cpu", **pinned),
        "stencil_iterate": lambda: tst.stencil_iterate(
            x, O7, W7, 1, tune=tuner, device="cpu", **pinned),
        "multi_stencil_pallas": lambda: tst.multi_stencil_pallas(
            [x], [O7], [W7], tune=tuner, device="cpu", **pinned),
    }
    with pytest.raises(ValueError, match="tune="):
        calls[frontend]()


def test_a_tuner_of_another_device_is_refused():
    x = np.zeros((8, 16, 32), np.float32)
    with pytest.raises(ValueError, match="measures on"):
        tst.stencil_pallas(x, O7, W7, tune=AutoTuner(device=None),
                           device="cpu")


def test_resolve_tuner():
    assert resolve_tuner(None) is None
    assert resolve_tuner(False) is None
    t = resolve_tuner(True)
    assert isinstance(t, AutoTuner) and t.device is None
    assert resolve_tuner(True) is t          # process-wide singleton
    assert resolve_tuner(True, "cpu") is resolve_tuner(True, "cpu")
    assert resolve_tuner(True, "cpu") is not t
    mine = _tuner()
    assert resolve_tuner(mine) is mine


# -- the frontend's memo of calls never hides a measured winner ----------------


def test_planner_with_a_tuned_db_plans_each_call(memory_defaults):
    """A planner with ``tuned_db=`` answers a planned call
    with the analytic plan while the DB is empty, and with the measured
    winner once one is recorded for the same request — not with the plan
    its memo kept."""
    db = TunedPlanDB(persistent=False)
    planner = Planner(cache=PlanCache(persistent=False), tuned_db=db,
                      device="cpu")
    planner_mod._DEFAULT = planner
    x = np.random.default_rng(4).standard_normal((12, 16, 32)).astype(
        np.float32)
    kw = dict(vmem_budget=32 * 1024, device="cpu")
    first = tst.stencil_pallas(x, O7, W7, **kw)
    assert not planner.last_plan_tuned
    analytic = planner.plan(_request(aligned=True, n_operands=2))
    # record a winner that differs from the analytic plan
    cands = planner.candidates(analytic.request, k=4)
    other = next(c for c in cands[1:] if c.tile != analytic.tile)
    rec = TuneRecord(
        key=analytic.request.cache_key(),
        fingerprint=backend_fingerprint("cpu"),
        candidates=tuple(_timing(c, 1e-3 * (i + 1)) for i, c in
                         enumerate([analytic, other])),
        winner=1, analytic=0, never_slower=True, speedup_vs_analytic=1.0,
        rank_correlation=0.0, winner_plan=other, tuned_at="now",
    )
    db.put(rec)
    served = []
    plan_fn = planner._tuned_winner

    def spy(key):
        p = plan_fn(key)
        served.append(p)
        return p

    planner._tuned_winner = spy
    again = tst.stencil_pallas(x, O7, W7, **kw)
    assert served == [other] and planner.last_plan_tuned
    assert torch.equal(first, again)


def _timing(plan, median_s):
    from repro_torch.plan import CandidateTiming

    return CandidateTiming(
        tile=plan.tile, sweep_axis=plan.sweep_axis,
        fused_depth=plan.fused_depth, shard_axis=None,
        modeled_bytes=plan.traffic_bytes, median_s=median_s, iqr_s=0.0,
        reps=1, achieved_gbps=0.0, model_measured_ratio=1.0,
        window_kind=plan.window_kind, modeled_ms=plan.modeled_ms,
    )


def test_tune_routes_through_the_tuner_not_the_memo(memory_defaults,
                                                    monkeypatch):
    """``tune=`` asks ``resolve_tuner(tune).plan``, never the
    default planner's memo of calls, on the first call and on the warm
    one."""
    x = np.random.default_rng(5).standard_normal((8, 16, 32)).astype(
        np.float32)
    tst.stencil_pallas(x, O7, W7, vmem_budget=16 * 1024, device="cpu")

    def refuse(*a, **k):
        raise AssertionError("tune= reached Planner.plan_call")

    monkeypatch.setattr(memory_defaults, "plan_call", refuse)
    tuner = _tuner()
    asked = []
    plan_fn = tuner.plan

    def spy(*a, **kw):
        asked.append(kw["shape"])
        return plan_fn(*a, **kw)

    tuner.plan = spy
    for _ in range(2):
        tst.stencil_pallas(x, O7, W7, vmem_budget=16 * 1024, tune=tuner,
                           device="cpu")
    assert asked == [(8, 16, 32)] * 2 and tuner.last_plan_tuned


# -- the device rule ---------------------------------------------------------


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is the card")


def test_default_tuner_and_measure_run_on_the_card():
    _no_cuda()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        measure(lambda: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AutoTuner(db=TunedPlanDB(persistent=False)).plan(_request())


# -- the shared timing harness ----------------------------------------------


def test_median_iqr_math():
    med, iqr = _median_iqr([3.0, 1.0, 2.0])
    assert med == 2.0
    assert iqr == pytest.approx(1.0)         # q75=2.5, q25=1.5 (interp)
    med, iqr = _median_iqr([4.0, 1.0, 2.0, 3.0])
    assert med == 2.5
    assert iqr == pytest.approx(1.5)
    med, iqr = _median_iqr([7.0])
    assert med == 7.0 and iqr == 0.0


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_median_iqr_and_spearman_equal_reference(n):
    rng = np.random.default_rng(n)
    xs = rng.standard_normal(n).tolist()
    ys = (rng.standard_normal(n) * 3.0).tolist()
    assert _median_iqr(xs) == j_median_iqr(xs)
    mid, iqr = _median_iqr(xs)
    assert mid == pytest.approx(float(np.median(xs)))
    assert iqr == pytest.approx(float(np.subtract(*np.percentile(
        xs, [75, 25]))))
    assert _spearman(xs, ys) == j_spearman(xs, ys)
    ties = np.round(np.asarray(ys)).tolist()
    assert _spearman(xs, ties) == j_spearman(xs, ties)


def test_measure_call_accounting_and_validation():
    calls = []
    res = measure(lambda: calls.append(0), reps=4, warmup=2, device="cpu")
    assert len(calls) == 6                   # warmup excluded from reps
    assert res.reps == 4 and res.warmup == 2
    assert len(res.times_s) == 4
    assert res.median_s >= 0.0 and res.iqr_s >= 0.0
    with pytest.raises(ValueError):
        measure(lambda: None, reps=0, device="cpu")
    with pytest.raises(ValueError):
        measure(lambda: None, warmup=-1, device="cpu")


def test_device_fingerprint_shape():
    fp = device_fingerprint("cpu")
    backend, kind, count, ver = fp.split(":")
    assert backend == "cpu" and kind and count == "x1"
    assert ver == f"torch-{torch.__version__}"
    # The tuner's composite adds the kernels' source hash on top.
    assert backend_fingerprint("cpu").startswith(fp + "|kernels=")


def test_spearman():
    assert _spearman([1, 2, 3], [10, 20, 30]) == pytest.approx(1.0)
    assert _spearman([1, 2, 3], [30, 20, 10]) == pytest.approx(-1.0)
    assert _spearman([1], [1]) == 0.0
    assert _spearman([5, 5, 5], [1, 2, 3]) == 0.0
    assert _spearman([1, 2, 3, 4], [1, 8, 27, 1000]) == pytest.approx(1.0)


# -- the command lines ------------------------------------------------------


def test_tune_cli_and_explain_tuned(tmp_path, capsys):
    from repro_torch.plan.explain import main as explain_main
    from repro_torch.plan.tune import main as tune_main

    db = str(tmp_path / "db")
    args = ["8x16x32", "--stencil", "star:1", "--budget", "16384",
            "-k", "2", "--reps", "2", "--device", "cpu", "--db", db]
    assert tune_main(args) == 0
    out = capsys.readouterr().out
    assert "measured fresh" in out and "model/meas" in out
    assert tune_main(args) == 0
    assert "warm DB hit" in capsys.readouterr().out
    assert explain_main(["8x16x32", "--stencil", "star:1", "--geom", "none",
                         "--budget", "16384", "--tuned", "--db", db]) == 0
    out = capsys.readouterr().out
    assert "tuned record (measured candidates)" in out and "<-- winner" in out
    assert explain_main(["8x16x32", "--stencil", "star:2", "--geom", "none",
                         "--budget", "16384", "--tuned", "--db", db]) == 0
    assert "no record for this request" in capsys.readouterr().out


def test_format_record_marks_rows(tuned_chain):
    _, _, rec = tuned_chain
    text = format_record(rec)
    assert "<-- winner" in text and "(advisory)" in text
    assert text.count("\n") == 4 + len(rec.candidates) + 1
