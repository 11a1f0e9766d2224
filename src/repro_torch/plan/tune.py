"""Measured-cost autotune loop of the port:  python -m repro_torch.plan.tune 512x512x512

The planner scores candidates by a model of the card (modelled ms,
``core.tiling.launch_model``); this module closes the loop by measuring:

1. ask the :class:`~repro_torch.plan.planner.Planner` for the top-``k``
   candidate plans by modelled time (``Planner.candidates``);
2. time every candidate on the tuner's device with
   :func:`repro_torch.runtime.timing.measure` (warm-up excluded, each rep
   between CUDA events with the device synchronized, median-of-n with
   IQR);
3. record the median, IQR, modelled bytes and modelled ms, and the
   model-vs-measured ratio per candidate into the persistent
   :class:`~repro_torch.plan.tunedb.TunedPlanDB` (the PlanCache's sha256
   request keys, further keyed by :func:`backend_fingerprint`);
4. keep the measured winner.  The analytic choice is always candidate 0
   and always raced, so the ``never_slower`` gate — measured winner time
   ≤ measured analytic time — holds by construction and is asserted at
   tune time.

Beyond the geometry candidates the race covers two execution variants
(DESIGN.md §15): the *window flip* (the other ring/trapezoid frontier
layout of a fused plan, bit-wise neutral, eligible to win outright) and
the *storage-dtype variants* (intermediate stages stored bf16 or
int8-quantized).  Dtype variants change the computed values, so their
rows are **advisory**: recorded, never served as the winner of the
request they did not answer.

A Planner built with ``tuned_db=`` (or an :class:`AutoTuner` used
directly, or ``stencil_pallas(..., tune=True)``) then *prefers* the
measured winner on a warm DB hit — no re-measurement — and falls back
to the analytic choice unchanged on a miss.

The tuner makes its own inputs on its device from a ``torch.Generator``
seeded with 0 (the time depends on shapes and dtypes, not values) and
launches each candidate with ``plan=candidate``, so tuning never recurses
into tuning.  ``AutoTuner(device=None)`` measures on the card and raises
without CUDA; the tests pass ``device="cpu"``, which times the kernels'
plain versions.  A sharded request (``num_shards > 1``) races sharded
launches on the mesh the call hands over (``plan(..., mesh=)``); without
one the launch builds its own over ``num_shards`` devices of the tuner's
kind, which on a machine with fewer cards raises.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
from datetime import datetime, timezone

import numpy as np

from .. import obs, resolve_device
from .cache import PlanCache
from .planner import Planner, default_planner
from .schema import PlanRequest, StencilPlan
from .tunedb import CandidateTiming, TunedPlanDB, TuneRecord

__all__ = [
    "AutoTuner",
    "backend_fingerprint",
    "default_tuner",
    "format_record",
    "main",
    "resolve_tuner",
    "smoke",
]

_KERNELS_HASH: list[str] = []


def _kernels_hash() -> str:
    """The hash of what the kernels are built from: every ``csrc/*.cu``
    with the shared headers and the flags, as ``kernels/_build.py`` names
    the libraries (computed once a process)."""
    if not _KERNELS_HASH:
        from ..kernels import _build

        h = hashlib.sha256()
        for src in sorted(_build.CSRC.glob("*.cu")):
            h.update(_build._target(src.stem).name.encode())
        _KERNELS_HASH.append(h.hexdigest()[:16])
    return _KERNELS_HASH[0]


def backend_fingerprint(device=None) -> str:
    """Identity of what a measurement means: the device fingerprint
    (``cuda:<name>:xN:torch-<ver>:cuda-<ver>``, or ``cpu:...`` for the
    plain versions) plus the hash of the kernels' sources — a measurement
    taken before a kernel changed is never served after it, and a CPU
    record never to the card or the reverse."""
    from ..runtime.timing import device_fingerprint

    return f"{device_fingerprint(device)}|kernels={_kernels_hash()}"


def _spearman(xs, ys) -> float:
    """Spearman rank correlation (average ranks on ties): how well the
    modelled ordering predicts the measured-time ordering — the
    per-request analogue of the paper's Fig. 5 model validation."""
    n = len(xs)
    if n < 2:
        return 0.0

    def ranks(v):
        v = np.asarray(v, dtype=float)
        order = np.argsort(v, kind="mergesort")
        r = np.empty(n, dtype=float)
        r[order] = np.arange(n, dtype=float)
        for val in np.unique(v):
            m = v == val
            r[m] = r[m].mean()
        return r

    rx, ry = ranks(xs), ranks(ys)
    sx, sy = rx - rx.mean(), ry - ry.mean()
    denom = float(np.sqrt((sx**2).sum() * (sy**2).sum()))
    if denom == 0.0:
        return 0.0
    return float((sx * sy).sum() / denom)


def _modeled_bytes(plan: StencilPlan) -> int:
    """A candidate's total modelled device-memory traffic: the (per-shard)
    chain bytes across all shards plus the cross-device halo exchange."""
    return (
        plan.per_shard_traffic_bytes * plan.num_shards
        + plan.halo_exchange_bytes
    )


class AutoTuner:
    """Races candidate plans on one device, keeps measured winners.

    ``tune()`` measures one request and records a :class:`TuneRecord`;
    ``plan()`` is the planning entry point the kernel layer's ``tune=``
    routes through — a warm DB hit returns the measured winner without
    re-measurement, a miss tunes first.  ``force=True`` re-measures even
    on a warm hit.  ``device`` (``None``: the card) is where the race
    runs and what the records are keyed by.
    """

    def __init__(
        self,
        db: TunedPlanDB | None = None,
        planner: Planner | None = None,
        k: int = 4,
        reps: int = 5,
        warmup: int = 1,
        device=None,
        force: bool = False,
    ):
        self.db = db if db is not None else TunedPlanDB()
        self.planner = planner if planner is not None else default_planner()
        self.k = int(k)
        self.reps = int(reps)
        self.warmup = int(warmup)
        self.device = device
        self.force = bool(force)
        self.last_plan_tuned: bool = False  # warm hit (vs fresh measurement)?
        self.last_record: TuneRecord | None = None

    # -- launching one candidate ------------------------------------------

    # Intermediate-stage int8 scale for the race: inputs are unit normals
    # and weights uniform 1/s, so stage values sit well inside ±128·0.05.
    # Values never change the timing; any fixed scale does.
    _RACE_QUANT = (0.05, 0)

    def _launch_fn(self, request: PlanRequest, plan: StencilPlan,
                   quants=None, mesh=None):
        """A zero-arg closure running the request's whole computation under
        ``plan`` — the thing :func:`repro_torch.runtime.timing.measure`
        times.  Inputs are drawn here on the tuner's device; weights are
        uniform 1/s so deep chains stay bounded.  ``plan=plan`` pins tile,
        sweep axis and depth, so the launch never consults a planner (and
        never re-tunes).

        Stage chains launch as explicit programs so the request's boundary
        conditions and stage dtypes survive into the launch;
        ``quants`` attaches per-stage ``(scale, zero_point)`` int8
        quantization.  An int8 stage that the request names without one
        gets :attr:`_RACE_QUANT`: the port refuses an int8 stage without a
        quantization, where the JAX package would truncate.  A sharded
        plan launches on ``mesh`` (the call's own)."""
        import torch

        from .. import ir
        from ..kernels.stencil import multi_stencil_pallas

        dev = resolve_device(self.device)
        dtype = {2: torch.bfloat16}.get(request.dtype_bytes, torch.float32)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)

        def mk():
            return torch.randn(request.shape, generator=gen, device=dev,
                               dtype=torch.float32).to(dtype)

        if request.stages:
            stage_list = [
                (
                    np.asarray(st.offsets, dtype=np.int64),
                    st.weights if st.weights is not None
                    else (1.0 / len(st.offsets),) * len(st.offsets),
                )
                for st in request.stages
            ]
            dts = tuple(st.dtype for st in request.stages)
            if quants is None and "int8" in dts:
                quants = tuple(
                    self._RACE_QUANT if dt == "int8" else None for dt in dts
                )
            prog = ir.chain_program(
                stage_list, len(request.shape),
                boundary=(
                    list(request.bcs)
                    if any(bc is not None for bc in request.bcs) else None
                ),
                dtypes=dts if any(dt is not None for dt in dts) else None,
                quants=quants,
            )
            us = (mk(),)
            return lambda: multi_stencil_pallas(
                us, None, None, plan=plan, program=prog, device=dev,
                mesh=mesh,
            )
        offsets_list = [
            np.asarray(g, dtype=np.int64) for g in request.offsets
        ]
        weights_list = [(1.0 / len(g),) * len(g) for g in offsets_list]
        us = tuple(mk() for _ in offsets_list)
        return lambda: multi_stencil_pallas(
            us, offsets_list, weights_list, plan=plan,
            time_steps=request.time_steps, device=dev, mesh=mesh,
        )

    # -- the §15 variant survey --------------------------------------------

    def _remake(self, request: PlanRequest, dtypes=None,
                window_kind=None) -> PlanRequest:
        """The same planning problem with the stage dtypes or the frontier
        window rewritten — the variant rows' launch requests."""
        return PlanRequest.make(
            shape=request.shape,
            stages=request.stages,
            dtypes=dtypes,
            bcs=request.bcs or None,
            dtype_bytes=request.dtype_bytes,
            vmem_budget=request.vmem_budget,
            n_operands=request.n_operands,
            geometry=request.geometry,
            aligned=request.aligned,
            pipelined=request.pipelined,
            strategy=request.strategy,
            max_pad=request.max_pad,
            num_shards=request.num_shards,
            mesh_axis=request.mesh_axis,
            window_kind=(
                window_kind if window_kind is not None
                else request.window_kind
            ),
            hardware=request.hardware,
        )

    def _variants(self, request: PlanRequest, plan0: StencilPlan):
        """Entries beyond the geometry candidates (DESIGN.md §15):

        * the **window flip** — the same request re-planned under the
          other frontier layout, when the analytic plan fuses.  Ring and
          trapezoid launches are bit-wise identical, so the flip races
          *for the win* (``advisory=False``); the served plan keeps the
          original request (same cache key), only ``window_kind`` differs.
        * **storage-dtype variants** — the chain with its intermediate
          stages stored bf16 / int8-quantized.  These change the computed
          values, so they race **advisory-only**: their rows record what
          narrower frontiers would buy, but they can never be served as
          the winner of the request they did not answer.

        Returns ``(plan, launch_request, quants, advisory)`` tuples.
        """
        from dataclasses import replace

        out = []
        T = len(request.stages)
        if T >= 2 and request.window_kind == "auto" \
                and plan0.fused_depth >= 2:
            other = (
                "ring" if plan0.window_kind == "trapezoid" else "trapezoid"
            )
            try:
                wk_plan = self.planner._analytic(
                    self._remake(request, window_kind=other)
                )
            except ValueError:
                wk_plan = None  # no tile fits this layout's frontiers
            if wk_plan is not None and wk_plan.window_kind != \
                    plan0.window_kind:
                out.append(
                    (replace(wk_plan, request=request), request, None, False)
                )
        if T >= 2 and all(st.dtype is None for st in request.stages):
            for name in ("bfloat16", "int8"):
                dts = (name,) * (T - 1) + (None,)
                qns = (
                    (self._RACE_QUANT,) * (T - 1) + (None,)
                    if name == "int8" else None
                )
                try:
                    var_req = self._remake(request, dtypes=dts)
                    var_plan = self.planner._analytic(var_req)
                except ValueError:
                    continue  # e.g. unsupported dtype for this engine
                out.append((var_plan, var_req, qns, True))
        return out

    # -- the tune pass -----------------------------------------------------

    def tune(
        self, request: PlanRequest | None = None, /, mesh=None, **kw
    ) -> TuneRecord:
        """Measure the top-k candidates of one request and persist the
        result.  Candidate 0 is the planner's analytic argmin; the winner
        is the measured argmin (ties break toward the analytic choice),
        so ``never_slower`` holds by construction.  A sharded request's
        candidates launch on ``mesh``."""
        from ..runtime.timing import measure

        if request is None:
            kw.setdefault("strategy", self.planner.strategy)
            request = PlanRequest.make(**kw)
        key = request.cache_key()
        race_sp = None
        if obs.enabled():
            # Rank = candidate index: the planner returns them ordered by
            # modelled time, so rank 0 is the analytic argmin.
            race_sp = obs.span("tune_race", plan_key=key).__enter__()
        try:
            cands = self.planner.candidates(request, k=self.k)
            entries = [(plan, request, None, False) for plan in cands]
            entries += self._variants(request, cands[0])
            timed = []
            for rank, (plan, lreq, qns, advisory) in enumerate(entries):
                fn = self._launch_fn(lreq, plan, quants=qns, mesh=mesh)
                if obs.enabled():
                    with obs.span(
                        "tune_candidate", plan_key=key, rank=rank,
                        tile=list(plan.tile), fused_depth=plan.fused_depth,
                        window_kind=plan.window_kind, advisory=advisory,
                        modeled_bytes=_modeled_bytes(plan),
                        modeled_ms=plan.modeled_ms,
                    ) as csp:
                        t = measure(fn, reps=self.reps, warmup=self.warmup,
                                    device=self.device)
                        csp.set(median_ms=t.median_s * 1e3)
                else:
                    t = measure(fn, reps=self.reps, warmup=self.warmup,
                                device=self.device)
                del fn
                timed.append((plan, t))
        except BaseException:
            if race_sp is not None:
                race_sp.set(outcome="error")
                race_sp.__exit__(None, None, None)
            raise
        base_t = max(timed[0][1].median_s, 1e-12)
        base_ms = max(entries[0][0].modeled_ms, 1e-12)
        rows = []
        for (plan, lreq, _, advisory), (_, t) in zip(entries, timed):
            m = _modeled_bytes(plan)
            med = max(t.median_s, 1e-12)
            row_dts = tuple(st.dtype for st in lreq.stages)
            rows.append(CandidateTiming(
                tile=plan.tile,
                sweep_axis=plan.sweep_axis,
                fused_depth=plan.fused_depth,
                shard_axis=plan.shard_axis,
                modeled_bytes=m,
                median_s=t.median_s,
                iqr_s=t.iqr_s,
                reps=t.reps,
                achieved_gbps=m / med / 1e9,
                model_measured_ratio=(
                    (plan.modeled_ms / base_ms) / (med / base_t)
                ),
                window_kind=plan.window_kind,
                stage_dtypes=(
                    row_dts if any(dt is not None for dt in row_dts)
                    else None
                ),
                advisory=advisory,
                modeled_ms=plan.modeled_ms,
            ))
        # Winner eligibility (§15): only semantics-preserving rows — the
        # geometry candidates and the bit-wise-neutral window flip — may
        # win; dtype-variant rows are information, not answers.
        winner = min(
            (i for i in range(len(rows)) if not rows[i].advisory),
            key=lambda i: (rows[i].median_s, i),
        )
        never_slower = rows[winner].median_s <= rows[0].median_s
        # The analytic plan is in the raced set, so the measured argmin
        # cannot lose to it — this gate failing means the harness itself
        # is broken, not the model.
        assert never_slower, (
            f"tuned winner slower than analytic: "
            f"{rows[winner].median_s} > {rows[0].median_s}"
        )
        if race_sp is not None:
            race_sp.set(
                candidates=len(rows), winner_rank=winner,
                source="measured", never_slower=never_slower,
            )
            race_sp.__exit__(None, None, None)
        rec = TuneRecord(
            key=key,
            fingerprint=backend_fingerprint(self.device),
            candidates=tuple(rows),
            winner=winner,
            analytic=0,
            never_slower=never_slower,
            speedup_vs_analytic=base_t / max(rows[winner].median_s, 1e-12),
            rank_correlation=_spearman(
                [r.modeled_ms for r in rows],
                [r.median_s for r in rows],
            ),
            winner_plan=timed[winner][0],
            tuned_at=datetime.now(timezone.utc).isoformat(
                timespec="seconds"
            ),
        )
        self.db.put(rec)
        self.last_record = rec
        return rec

    def plan(self, request: PlanRequest | None = None, /, mesh=None,
             **kw) -> StencilPlan:
        """Planning entry point with measured preference: warm DB hit →
        the measured winner (no re-measurement); miss → tune, then the
        winner.  Signature-compatible with ``Planner.plan``, which is
        what lets ``stencil_pallas(tune=...)`` swap it in; ``mesh`` is
        where a sharded race launches."""
        if request is None:
            kw.setdefault("strategy", self.planner.strategy)
            request = PlanRequest.make(**kw)
        if obs.enabled():
            with obs.span("plan", key=request.cache_key(),
                          source="autotuner") as sp:
                plan = self._plan_resolve(request, mesh)
                sp.set(
                    tuned=self.last_plan_tuned,
                    tile=list(plan.tile),
                    fused_depth=plan.fused_depth,
                    num_shards=plan.num_shards,
                    modeled_ms=plan.modeled_ms,
                )
            return plan
        return self._plan_resolve(request, mesh)

    def _plan_resolve(self, request: PlanRequest, mesh=None) -> StencilPlan:
        rec = None
        if not self.force:
            rec = self.db.get(
                request.cache_key(), backend_fingerprint(self.device)
            )
        self.last_plan_tuned = rec is not None
        if rec is None:
            rec = self.tune(request, mesh=mesh)
        self.last_record = rec
        return rec.winner_plan


_DEFAULT: dict = {}


def default_tuner(device=None) -> AutoTuner:
    """The process-wide tuner of ``device`` (``None``: the card) over the
    default planner and the persistent DB — what
    ``stencil_pallas(tune=True)`` resolves to."""
    key = None
    if device is not None:
        import torch

        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = str(dev)
    tuner = _DEFAULT.get(key)
    if tuner is None:
        tuner = _DEFAULT[key] = AutoTuner(device=key)
    return tuner


def resolve_tuner(tune, device=None) -> AutoTuner | None:
    """The kernel layer's ``tune=`` knob: ``None``/``False`` → no tuning,
    ``True`` → the default tuner of ``device``, an :class:`AutoTuner` →
    itself."""
    if tune is None or tune is False:
        return None
    if tune is True:
        return default_tuner(device)
    return tune


# -- reporting -------------------------------------------------------------


def _fmt_t(s: float) -> str:
    if s >= 1.0:
        return f"{s:.3f} s"
    if s >= 1e-3:
        return f"{s * 1e3:.3f} ms"
    return f"{s * 1e6:.1f} us"


def format_record(rec: TuneRecord) -> str:
    """The measured-vs-modelled table of one tune record (also what
    ``repro_torch.plan.explain --tuned`` prints for a warm entry)."""
    lines = [
        f"tuned entry {rec.key[:16]}…  backend {rec.fingerprint}",
        f"  tuned at {rec.tuned_at}  (schema v{rec.schema}, "
        f"planner v{rec.planner_version})",
        "  candidates (measured on the backend above):",
        "    #  tile              sweep depth shard window     dtypes   "
        "modeled MiB  modeled ms  measured      iqr        model/meas",
    ]
    for i, c in enumerate(rec.candidates):
        mark = (
            "  <-- winner" if i == rec.winner else
            "  (analytic)" if i == rec.analytic else
            "  (advisory)" if c.advisory else ""
        )
        dts = "-"
        if c.stage_dtypes:
            named = {dt for dt in c.stage_dtypes if dt is not None}
            dts = "/".join(sorted(named)) or "-"
        lines.append(
            f"    {i}  {str(c.tile):<17} {str(c.sweep_axis):>5} "
            f"{c.fused_depth:>5} {str(c.shard_axis):>5} "
            f"{str(c.window_kind):>9} {dts:>8} "
            f"{c.modeled_bytes / (1 << 20):>12.2f} "
            f"{c.modeled_ms:>11.4f}  "
            f"{_fmt_t(c.median_s):>9}  {_fmt_t(c.iqr_s):>9}  "
            f"{c.model_measured_ratio:>9.3f}"
            f"{mark}"
        )
    lines += [
        f"  winner: candidate {rec.winner} "
        f"({rec.speedup_vs_analytic:.3f}x vs analytic; never_slower="
        f"{rec.never_slower})",
        f"  rank correlation (modelled ms vs measured time): "
        f"{rec.rank_correlation:+.3f} over {len(rec.candidates)} candidates",
    ]
    return "\n".join(lines)


# -- CLI -------------------------------------------------------------------


def smoke(device=None) -> int:
    """Gate: tune one small grid end to end (k=2, 3 reps) on ``device``
    and assert the loop's promises — never_slower holds, the record
    round-trips, a Planner with the DB attached serves the measured winner
    on a warm hit in < 1 ms without re-measuring; then a T=3 chain races
    the advisory bf16/int8 storage variants."""
    import time

    from ..core.cache_fitting import star_stencil

    db = TunedPlanDB(persistent=False)
    tuner = AutoTuner(
        db=db, planner=Planner(cache=PlanCache(persistent=False)),
        k=2, reps=3, warmup=1, device=device,
    )
    kw = dict(
        shape=(16, 16, 128), offsets=star_stencil(3, 1),
        vmem_budget=64 * 1024, aligned=True,
    )
    t0 = time.perf_counter()
    rec = tuner.tune(**kw)
    tune_s = time.perf_counter() - t0
    assert rec.never_slower, "never_slower gate failed"
    assert rec.speedup_vs_analytic >= 1.0
    assert len(rec.candidates) >= 1
    assert TuneRecord.from_dict(rec.to_dict()) == rec, "record round-trip"
    print(format_record(rec))

    # Warm preference: the planner serves the measured winner, fast.
    planner = Planner(cache=PlanCache(persistent=False), tuned_db=db,
                      device=device)
    measured_before = db.stats["misses"]
    warm = []
    for _ in range(3):  # best-of-3: absorb one-time fingerprint warm-up
        t0 = time.perf_counter()
        served = planner.plan(**kw)
        warm.append((time.perf_counter() - t0) * 1e3)
        assert planner.last_plan_tuned, "warm hit not served from tuned DB"
        assert served == rec.winner_plan
    assert db.stats["misses"] == measured_before, "warm hit re-measured"
    warm_ms = min(warm)
    assert warm_ms < 1.0, f"warm tuned hit took {warm_ms:.2f} ms"
    print(
        f"tune smoke: {len(rec.candidates)} candidates in {tune_s:.2f} s, "
        f"winner {rec.winner} ({rec.speedup_vs_analytic:.3f}x), "
        f"warm_hit={warm_ms:.3f} ms  OK"
    )

    # The variant race: a chain puts the bf16/int8 storage variants on
    # the track, advisory only; never-slower holds over the eligible rows.
    t0 = time.perf_counter()
    chain = tuner.tune(
        shape=(32, 256), offsets=star_stencil(2, 1), time_steps=3,
        vmem_budget=64 * 1024, aligned=True,
    )
    chain_s = time.perf_counter() - t0
    assert chain.never_slower, "chain never_slower gate failed"
    named = {
        dt for c in chain.candidates if c.stage_dtypes
        for dt in c.stage_dtypes if dt is not None
    }
    assert named == {"int8", "bfloat16"}, (
        f"dtype variants missing from the race: {named}"
    )
    assert all(
        c.advisory for c in chain.candidates if c.stage_dtypes
    ), "a numerics-changing dtype row raced as winner-eligible"
    assert not chain.candidates[chain.winner].advisory
    assert TuneRecord.from_dict(chain.to_dict()) == chain
    print(format_record(chain))
    print(
        f"tune smoke (chain): {len(chain.candidates)} rows in "
        f"{chain_s:.2f} s, windows="
        f"{sorted({c.window_kind for c in chain.candidates})}, "
        f"advisory dtypes={sorted(named)}  OK"
    )
    return 0


def _parse_shape(s: str) -> tuple[int, ...]:
    for sep in ("x", ","):
        if sep in s:
            return tuple(int(p) for p in s.split(sep) if p)
    return (int(s),)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.plan.tune",
        description=(
            "Race the planner's top-k candidate plans on the card (or the "
            "CPU's plain versions) and persist the measured winner."
        ),
    )
    ap.add_argument("shape", nargs="?", default="64x64x128",
                    help="grid shape, e.g. 512x512x512")
    ap.add_argument("--stencil", default="star:2",
                    help="star:R or box:R (default star:2)")
    ap.add_argument("--geom", default="none",
                    help="cache geometry a,z,w for the lattice steps "
                         "(default none; pass the same value used with "
                         "repro_torch.plan.explain so the request keys "
                         "match)")
    ap.add_argument("--dtype-bytes", type=int, default=4)
    ap.add_argument("--budget", type=int, default=None,
                    help="shared-memory bytes per CTA (default 227 KB)")
    ap.add_argument("--time-steps", type=int, default=1,
                    help="tune the T-application chain")
    ap.add_argument("--num-shards", type=int, default=1,
                    help="tune the column-sharded launch over N devices: "
                         "the first N cards, or the CPU with --device cpu")
    ap.add_argument("--unaligned", action="store_true",
                    help="free tile extents (no 128-byte minor grain)")
    ap.add_argument("-k", type=int, default=4,
                    help="candidates to race (default 4)")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed reps per candidate (default 5)")
    ap.add_argument("--warmup", type=int, default=1,
                    help="un-timed warm-up calls per candidate (default 1)")
    ap.add_argument("--device", default=None,
                    help="where to measure: cuda (default) or cpu (the "
                         "kernels' plain versions)")
    ap.add_argument("--db", default=None,
                    help="tuned DB dir (default $REPRO_TORCH_TUNED_DB_DIR "
                         "or ~/.cache/repro_torch/tuned)")
    ap.add_argument("--memory-only", action="store_true",
                    help="do not persist the record to disk")
    ap.add_argument("--force", action="store_true",
                    help="re-measure even when a warm entry exists")
    ap.add_argument("--json", action="store_true",
                    help="dump the tune record JSON")
    ap.add_argument("--smoke", action="store_true",
                    help="run the smoke gates instead")
    args = ap.parse_args(argv)

    if args.smoke:
        return smoke(args.device)

    from ..core.cache_fitting import box_stencil, star_stencil
    from ..kernels.stencil import _planning_hardware

    shape = _parse_shape(args.shape)
    kind, _, r = args.stencil.partition(":")
    r = int(r or 2)
    if kind == "star":
        offs = star_stencil(len(shape), r)
    elif kind == "box":
        offs = box_stencil(len(shape), r)
    else:
        raise SystemExit(f"unknown stencil spec {args.stencil!r}")

    db = TunedPlanDB(db_dir=args.db, persistent=not args.memory_only)
    tuner = AutoTuner(
        db=db, k=args.k, reps=args.reps, warmup=args.warmup,
        device=args.device, force=args.force,
        planner=Planner(cache=PlanCache(persistent=False)),
    )
    geometry = None if args.geom.lower() == "none" else _parse_shape(args.geom)
    mesh = None
    if args.num_shards > 1:
        from ..launch.mesh import make_column_mesh

        mesh = make_column_mesh(args.num_shards, device=args.device)
    tuner.plan(
        shape=shape, offsets=offs, dtype_bytes=args.dtype_bytes,
        vmem_budget=args.budget, geometry=geometry,
        time_steps=args.time_steps, aligned=not args.unaligned,
        hardware=_planning_hardware(resolve_device(args.device)),
        num_shards=args.num_shards, mesh=mesh,
    )
    rec = tuner.last_record
    if args.json:
        import json
        print(json.dumps(rec.to_dict(), indent=2, sort_keys=True))
        return 0
    served = "warm DB hit (no re-measurement)" if tuner.last_plan_tuned \
        else "measured fresh"
    print(format_record(rec))
    print(f"  served: {served}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
