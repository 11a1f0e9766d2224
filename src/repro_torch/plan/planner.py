"""The stencil plan compiler of the port — the paper's pipeline as one pass,
scored by the Hopper cost model.

``Planner.plan`` runs, in order:

1. **Interference lattice** (§4, Eq. 8/9): build the Eq. 9 basis of the
   grid's interference lattice for the target cache of S words, LLL-reduce
   it, and find the shortest vector.
2. **Unfavorable-grid detection** (§6): the grid is unfavorable when the
   shortest L1 lattice vector is below the stencil diameter divided by the
   associativity — the Fig. 5 miss spikes.
3. **Padding proposal** (§6, Appendix B): minimal padding of the leading
   dims that clears the threshold (``core.padding.pad_grid``), emitted as
   a :class:`~repro_torch.plan.schema.PadPlan`.
4. **Tile enumeration + scoring**: the candidate tiles
   (``core.tiling.candidate_tiles``) *plus* two lattice-informed boxes —
   the bounding box of the reduced-basis parallelepiped and the
   surface-to-volume-optimal box — each feasible where its kernel's
   shared memory fits the budget, all scored by modelled time on the
   request's card (``core.tiling.launch_model``).  With ``time_steps=T >
   1`` the scoring repeats at every fusion depth 1..T and the depth whose
   whole chain (``ceil(T / depth)`` launches) models fastest wins; depth 1
   is always a candidate, so a fused plan is chosen only where its
   modelled *time* wins.
5. **Freeze**: the winning (pad, tile, sweep axis, depth, window kind)
   plus modelled time, traffic, shared memory, residency, the
   isoperimetric lower bound and the legacy-heuristic baseline become a
   frozen, serializable :class:`~repro_torch.plan.schema.StencilPlan`.

Steps 1–3 run whenever the request carries a cache ``geometry`` (a, z,
w), exactly as the reference's do.  On the H100 every window is staged in
shared memory but every load passes through a hardware-managed L2 whose
set mapping is not documented, so the geometry is the caller's input.

Which kernel runs a launch follows the frontend: one application with no
boundary and no stage dtype runs ``sweep_apply`` (2 CTAs an SM), every
other launch ``sweep_chain`` (1 CTA an SM).

``strategy="legacy"`` is the default candidate set at depth 1;
``strategy="paper"`` adds the lattice candidates and every depth, and
asserts it never models slower than legacy.  A planner built with
``tuned_db=`` (a :class:`~repro_torch.plan.tunedb.TunedPlanDB`) prefers
a winner measured for the same request on the same device (``device=``,
default the card) over its own choice; a miss plans analytically,
unchanged.  With recording on (:mod:`repro_torch.obs`) every plan is a
``plan`` span.

With ``num_shards=S > 1`` (column sharding) step 4 runs on the *worst
shard's column slab*, with the sweep kept off the shard axis, so every
time, traffic and flop figure is per shard; the plan also freezes the
shard axis and the halo-exchange bytes, which it reports but does not
score (as the reference prices them).  ``num_shards=1`` is the same
request as an unsharded one.
"""

from __future__ import annotations

import time
from math import prod
from typing import Sequence

import numpy as np

from .. import obs
from ..core.lattice import (
    CacheGeometry,
    basis_eccentricity,
    interference_basis,
    lll_reduce,
    shortest_vector,
)
from ..core.padding import hyperbola_index, pad_grid
from ..core.tiling import (
    HopperDevice,
    TileChoice,
    chain_flops,
    chain_halo,
    dtype_itemsize,
    halo_from_offsets,
    launch_model,
    launch_smem,
    minor_unit,
    select_tile,
    tile_traffic_bytes,
)
from .cache import PlanCache
from .schema import LatticeReport, PadPlan, PlanRequest, StencilPlan

__all__ = ["Planner", "default_planner", "plan_stencil"]

# The chain kernel's fixed tables (csrc/sweep_chain.cu kMaxStages,
# kMaxTaps): a deeper or wider fused launch is never a candidate.
_MEMO_HIT = obs.counter("plan_memo_hit")
_MEMO_MISS = obs.counter("plan_memo_miss")
_CHAIN_MAX_STAGES = 8
_CHAIN_MAX_TAPS = 160


def _program_stage_halos(request: PlanRequest, d: int):
    """Per-stage operator halos of a chain request, from its canonical
    serialized stencil program (the IR's shape inference over its apply
    ops); requests built without a program fall back to the stage list."""
    if request.program:
        from ..ir import Program, stage_halos as ir_stage_halos

        halos = ir_stage_halos(Program.from_json(request.program))
        if len(halos) == len(request.stages):
            return [tuple(h) for h in halos]
    return [halo_from_offsets([st.offsets], d) for st in request.stages]


def _align_extent(t: int, n: int, unit: int) -> int:
    """Clamp a tile extent to [1, n], snapped down to ``unit`` multiples
    (or up to min(unit, n) when below the grain)."""
    t = max(1, min(int(t), int(n)))
    if n < unit:
        return n
    if t < unit:
        return min(unit, n)
    return (t // unit) * unit


def _fit_to_budget(tile, shape, halo, dtype_bytes, budget, aligned):
    """Shrink a candidate box (halving its largest extent) until its halo'd
    window fits ``budget`` bytes.  Returns None if even the unit tile does
    not fit."""
    tile = list(tile)
    d = len(tile)
    for _ in range(64):
        window = prod(t + lo + hi for t, (lo, hi) in zip(tile, halo))
        if window * dtype_bytes <= budget:
            return tuple(tile)
        i = max(range(d), key=lambda j: tile[j])
        if tile[i] <= 1:
            return None
        tile[i] = max(1, tile[i] // 2)
        if aligned and i == d - 1:
            tile[i] = _align_extent(tile[i], shape[i], minor_unit(dtype_bytes))
    return None


class _Survey:
    """One request's scored planning state, shared by ``plan()``'s argmin
    and ``candidates()``'s enumeration: the lattice/pad decisions, the
    legacy baseline, the per-depth best tiles with their whole-chain
    prices, and the ``tiled``/``price_chain`` closures for scoring further
    (depth, sweep-axis) combinations under identical budgets."""

    __slots__ = (
        "request", "T", "halo", "stage_halos", "lattice", "pad", "work",
        "work_full", "shard_axis", "stage_dbs", "extras", "legacy",
        "legacy_priced", "per_depth", "scored", "tiled", "price_chain",
        "window_kind",
    )

    def __init__(self, **kw):
        for name in self.__slots__:
            setattr(self, name, kw.pop(name))
        assert not kw, f"unexpected survey fields: {sorted(kw)}"


class Planner:
    """Compiles :class:`PlanRequest` → :class:`StencilPlan`, memoized by a
    :class:`PlanCache` (content-addressed, persistent)."""

    def __init__(
        self,
        strategy: str = "paper",
        cache: PlanCache | None = None,
        tuned_db=None,
        device=None,
    ):
        assert strategy in ("paper", "legacy"), strategy
        self.strategy = strategy
        self.cache = cache if cache is not None else PlanCache()
        # Optional TunedPlanDB: when attached, plan() prefers a measured
        # winner recorded for this exact request on ``device`` (None: the
        # card) and these kernels; a miss falls back to the analytic choice.
        self.tuned_db = tuned_db
        self.device = device
        self.last_plan_seconds: float | None = None  # cold-vs-warm telemetry
        self.last_plan_tuned: bool = False           # did a tuned entry win?
        self._by_call: dict = {}

    # -- cheap diagnostics (no tile search) --------------------------------

    def lattice_report(
        self, shape: Sequence[int], S: int, diameter: int, a: int = 1
    ) -> LatticeReport:
        """Steps 1–2 of the pipeline for one grid: basis → LLL → shortest
        vector → §6 unfavorable criterion + Fig. 5 hyperbola fit."""
        shape = tuple(int(n) for n in shape)
        B = interference_basis(shape, S)
        R = lll_reduce(B)
        v = shortest_vector(R, norm="l1")
        l1 = float(np.abs(v).sum())
        l2 = float(np.sqrt((v.astype(np.float64) ** 2).sum()))
        threshold = diameter / a
        k, dist = (
            hyperbola_index(shape, S) if len(shape) >= 2 else (0, float("inf"))
        )
        return LatticeReport(
            S=int(S),
            basis=tuple(tuple(int(x) for x in row) for row in B),
            reduced=tuple(tuple(int(x) for x in row) for row in R),
            shortest=tuple(int(x) for x in v),
            shortest_l1=l1,
            shortest_l2=l2,
            eccentricity=float(basis_eccentricity(R)),
            diameter=int(diameter),
            threshold=float(threshold),
            unfavorable=l1 < threshold,
            hyperbola_k=int(k),
            hyperbola_dist=float(dist),
        )

    def pad_plan(
        self,
        shape: Sequence[int],
        S: int,
        diameter: int,
        a: int = 1,
        max_pad: int = 16,
        lattice: LatticeReport | None = None,
    ) -> PadPlan:
        """Step 3: minimal favorable padding, or an explained zero pad."""
        shape = tuple(int(n) for n in shape)
        rep = lattice or self.lattice_report(shape, S, diameter, a)
        if not rep.unfavorable:
            return PadPlan.zero(
                shape,
                shortest=rep.shortest_l1,
                threshold=rep.threshold,
                reason=(
                    f"favorable: shortest lattice vector |v|_1="
                    f"{rep.shortest_l1:.0f} >= {rep.threshold:.3g}"
                ),
            )
        padded, info = pad_grid(shape, S, diameter, a=a, max_pad=max_pad)
        return PadPlan(
            pad=tuple(p - n for p, n in zip(padded, shape)),
            padded_shape=tuple(int(n) for n in padded),
            extra_words=int(info["extra_words"]),
            shortest_before=float(info["shortest_before"]),
            shortest_after=float(info["shortest_after"]),
            threshold=float(info["threshold"]),
            reason=(
                f"unfavorable: shortest lattice vector {rep.shortest} "
                f"(|v|_1={rep.shortest_l1:.0f}) < {rep.threshold:.3g}; "
                f"near Fig. 5 hyperbola n1*n2 = k*S/2 with k={rep.hyperbola_k} "
                f"(rel. dist {rep.hyperbola_dist:.3f})"
            ),
        )

    # -- lattice-informed tile candidates ----------------------------------

    def _extra_candidates(
        self, shape, halo, request: PlanRequest, lattice: LatticeReport | None
    ) -> list[tuple[int, ...]]:
        d = len(shape)
        db = request.dtype_bytes
        n_in = max(len(request.offsets), 1)
        budget = request.vmem_budget // n_in
        cands: list[tuple[int, ...]] = []

        def add(tile):
            tile = tuple(
                _align_extent(t, n, minor_unit(db) if i == d - 1 else 1)
                if request.aligned
                else max(1, min(int(t), int(n)))
                for i, (t, n) in enumerate(zip(tile, shape))
            )
            fit = _fit_to_budget(tile, shape, halo, db, budget, request.aligned)
            if fit is not None and fit not in cands:
                cands.append(fit)

        # (a) Bounding box of the reduced-basis parallelepiped: the paper's
        # §4 fundamental parallelepiped has det = S and near-cubic shape
        # after LLL; copies move rectangles, so take its box hull.
        if lattice is not None:
            R = np.asarray(lattice.reduced, dtype=np.int64)
            add(np.abs(R).max(axis=0))
        # (b) s2v-optimal box: minimizing Σ_i h_i/T_i at fixed volume V
        # gives T_i ∝ h_i (Lagrange); scale to the budgeted volume.
        w = [max(lo + hi, 1) for lo, hi in halo]
        vol = max(budget // db, 1)
        scale = (vol / prod(w)) ** (1.0 / d)
        add([max(1, round(wi * scale)) for wi in w])
        # (c) the same box with each dim collapsed thin (the scanning face):
        # along the sweep axis the extent stops paying surface.
        for s in range(d):
            thin = [max(1, round(wi * scale)) for wi in w]
            thin[s] = 1
            add(thin)
        return cands

    # -- the full pipeline -------------------------------------------------

    def plan(self, request: PlanRequest | None = None, /, **kw) -> StencilPlan:
        """Compile (or fetch from cache) the plan for one request.  Keyword
        form builds the request via :meth:`PlanRequest.make`, with the
        planner's strategy as default."""
        if request is None:
            kw.setdefault("strategy", self.strategy)
            request = PlanRequest.make(**kw)
        key = request.cache_key()
        # Hot serving path: one predicate check with recording off.
        if obs.enabled():
            with obs.span("plan", key=key) as sp:
                plan = self._plan_resolve(request, key)
                sp.set(**_plan_span_args(plan, self.last_plan_tuned))
            return plan
        return self._plan_resolve(request, key)

    def _plan_resolve(self, request: PlanRequest, key: str) -> StencilPlan:
        t0 = time.perf_counter()
        self.last_plan_tuned = False
        if self.tuned_db is not None:
            tuned = self._tuned_winner(key)
            if tuned is not None:
                self.last_plan_tuned = True
                self.last_plan_seconds = time.perf_counter() - t0
                return tuned
        plan = self._analytic(request, key)
        self.last_plan_seconds = time.perf_counter() - t0
        return plan

    def _tuned_winner(self, key: str) -> StencilPlan | None:
        from .tune import backend_fingerprint

        rec = self.tuned_db.get(key, backend_fingerprint(self.device))
        return None if rec is None else rec.winner_plan

    def plan_call(self, signature, **kw) -> StencilPlan:
        """:meth:`plan` of the keyword request ``kw``, remembered under
        ``signature``, a hashable value the caller derives from what
        decides the request (the kernel frontends pass their static
        launch arguments), so that a repeated call neither builds the
        request nor hashes it: a warm lookup is one dict lookup, where
        building and keying a request costs a fraction of a millisecond
        of host time before the first launch.

        A traced call takes the same path as an untraced one: every call
        still shows a ``plan`` span (as the JAX package's frontends make
        it), a memo hit's carrying the memoized plan's arguments and
        ``memo="hit"``.  Each lookup bumps ``plan_memo_hit`` or
        ``plan_memo_miss`` (``repro_torch.obs.totals()``); a miss makes the
        open port call cold.  A planner with a tuned DB, whose answer
        changes when a winner is recorded, plans each call."""
        if self.tuned_db is not None:
            return self.plan(**kw)
        plan = self._by_call.get(signature)
        if plan is not None:
            obs.count(_MEMO_HIT)
            if obs.enabled():
                with obs.span("plan", key=plan.request.cache_key(),
                              memo="hit", **_plan_span_args(plan, False)):
                    pass
            return plan
        obs.count(_MEMO_MISS)
        obs.mark_cold()
        plan = self.plan(**kw)
        if len(self._by_call) >= 1024:
            self._by_call.clear()
        self._by_call[signature] = plan
        return plan

    def _analytic(
        self, request: PlanRequest, key: str | None = None
    ) -> StencilPlan:
        """The model-driven plan (PlanCache-memoized), never consulting the
        tuned DB — the autotuner's baseline and candidate source."""
        key = key if key is not None else request.cache_key()
        cached = self.cache.get(key)
        if cached is not None:
            return cached
        plan = self._compile(request)
        self.cache.put(key, plan)
        return plan

    # -- candidate enumeration (the autotune surface) ----------------------

    def candidates(
        self, request: PlanRequest | None = None, /, k: int = 3, **kw
    ) -> list[StencilPlan]:
        """The top-``k`` candidate plans by modelled chain time:
        ``candidates()[0]`` is :meth:`plan`'s choice, the rest the best
        tile of each other (fusion depth, sweep axis) and the legacy
        tile — under sharding, for every other shard axis too — ranked by
        modelled time.  Every returned plan executes this request
        correctly; only their cost fields differ."""
        if request is None:
            kw.setdefault("strategy", self.strategy)
            request = PlanRequest.make(**kw)
        analytic = self._analytic(request)
        k = int(k)
        if k <= 1:
            return [analytic]
        seen = {(analytic.tile, analytic.sweep_axis, analytic.fused_depth,
                 analytic.shard_axis)}
        pool: list[tuple] = []

        def harvest(sv: "_Survey", shard_rank: int) -> None:
            axes = [i for i, n in enumerate(sv.work)
                    if n > 1 and i != sv.shard_axis]
            axes = axes or [i for i in range(len(sv.work))
                            if i != sv.shard_axis][:1]
            for depth in sorted(sv.scored):
                for rank, axis in enumerate(axes):
                    try:
                        c = sv.tiled(depth, sv.extras, sweep_axis=axis)
                    except ValueError:
                        continue  # no tile fits on this axis
                    priced = sv.price_chain(depth, c)
                    sig = (c.tile, c.sweep_axis, int(depth), sv.shard_axis)
                    if priced is None or sig in seen:
                        continue
                    seen.add(sig)
                    pool.append((priced[0], depth, shard_rank, rank, sv, c,
                                 priced))
            sig = (sv.legacy.tile, sv.legacy.sweep_axis, 1, sv.shard_axis)
            if sv.legacy_priced is not None and sig not in seen:
                seen.add(sig)
                pool.append((sv.legacy_priced[0], 1, shard_rank, len(axes),
                             sv, sv.legacy, sv.legacy_priced))

        sv0 = self._survey(request)
        harvest(sv0, 0)
        if request.num_shards > 1:
            # Another column partition changes the slab, the sweep axes
            # it admits and the exchange bytes: each is a candidate.
            dims = [i for i, n in enumerate(sv0.work_full) if n > 1]
            for j, axis in enumerate(a for a in dims
                                     if a != sv0.shard_axis):
                try:
                    sva = self._survey(request, shard_axis_override=axis)
                except (ValueError, AssertionError):
                    continue  # no feasible tiling under this partition
                harvest(sva, j + 1)
        pool.sort(key=lambda t: (t[0], t[1], t[2], t[3]))
        return [analytic] + [
            self._freeze(sv, int(depth), c, priced)
            for _ms, depth, _sr, _rank, sv, c, priced in pool[: k - 1]
        ]

    def _compile(self, request: PlanRequest) -> StencilPlan:
        sv = self._survey(request)
        single_ms = sv.scored[1][0]
        # Shallower wins ties: same modelled time, smaller shared webs.
        fused_depth = min(sv.scored, key=lambda t: (sv.scored[t][0], t))
        # Depth 1 is always a candidate, so the fused choice can never
        # model slower than the planner's own single-pass plan.
        assert sv.scored[fused_depth][0] <= single_ms
        return self._freeze(
            sv, fused_depth, sv.per_depth[fused_depth], sv.scored[fused_depth]
        )

    def _survey(self, request: PlanRequest,
                shard_axis_override: int | None = None) -> "_Survey":
        shape = request.shape
        d = len(shape)
        stages = request.stages
        if stages:
            # Stage chain: per-stage halos drive the launches; the union is
            # what the lattice/pad stages and the depth-1 tile see (a window
            # sized for the union admits every stage).
            stage_halos = _program_stage_halos(request, d)
            stage_points = [len(st.offsets) for st in stages]
            halo = halo_from_offsets([st.offsets for st in stages], d)
        else:
            stage_halos = None  # multi-RHS single application
            stage_points = [sum(len(g) for g in request.offsets)]
            halo = halo_from_offsets(request.offsets, d)
        diameter = max(lo + hi + 1 for lo, hi in halo)

        lattice = None
        if request.geometry is not None:
            geom = CacheGeometry(*request.geometry)
            S = geom.size_words
            # a=1: the §6 criterion at direct-mapped worst case, as the
            # reference applies it.
            lattice = self.lattice_report(shape, S, diameter, a=1)
            pad = self.pad_plan(
                shape, S, diameter, a=1, max_pad=request.max_pad,
                lattice=lattice,
            )
        else:
            pad = PadPlan.zero(
                shape,
                reason=(
                    "no cache geometry: the windows sit in shared memory, "
                    "padding not required"
                ),
            )
        work_full = pad.padded_shape
        T = request.time_steps
        db = request.dtype_bytes
        device = HopperDevice.from_key(request.hardware)
        n_in = max(len(request.offsets), 1)
        stage_dbs = (
            [dtype_itemsize(st.dtype) if st.dtype else db for st in stages]
            if stages else None
        )
        # The frontend's kernel choice: a chain with a boundary or a stage
        # dtype runs every launch, T = 1 included, on the chain kernel.
        chain_only = bool(request.bcs) or any(
            st.dtype is not None for st in stages
        )
        wk_req = request.window_kind
        if T <= 1:
            kinds = ("ring",) if wk_req == "auto" else (wk_req,)
        elif wk_req == "auto":
            kinds = ("ring", "trapezoid")
        else:
            kinds = (wk_req,)
        chosen = {"wk": kinds[0]}  # rebound after scoring (closure default)

        # Column sharding: a sharded request tiles the worst shard's slab,
        # the sweep kept off the shard axis, which is the longest axis
        # (ties to the lowest index) unless the caller names another.
        shard_axis = None
        work = work_full
        if request.num_shards > 1:
            dims = [i for i, n in enumerate(work_full) if n > 1] \
                or list(range(d))
            if shard_axis_override is not None:
                if shard_axis_override not in dims:
                    raise ValueError(
                        f"shard axis {shard_axis_override} not partitionable "
                        f"on padded grid {work_full}"
                    )
                shard_axis = int(shard_axis_override)
            else:
                shard_axis = max(dims, key=lambda i: (work_full[i], -i))
            work = tuple(
                max(-(-n // request.num_shards), 1) if i == shard_axis else n
                for i, n in enumerate(work_full)
            )

        def kernel_of(depth: int) -> str:
            return "chain" if depth > 1 or chain_only else "apply"

        def tiled(depth: int, extras=None, sweep_axis="auto",
                  window_kind=None) -> TileChoice:
            """Tile for one launch: depth 1 scores the per-application union
            halo at the most taps of any stage; deeper launches score the
            chain's leading ``depth``-stage run."""
            kernel = kernel_of(depth)
            if stage_halos is not None and depth > 1:
                launch, taps = stage_halos[:depth], stage_points[:depth]
                out_db = stage_dbs[depth - 1]
            else:
                launch, taps = None, [max(stage_points)]
                out_db = stage_dbs[0] if stage_dbs else db
            return select_tile(
                work, halo, dtype_bytes=db, vmem_budget=request.vmem_budget,
                sweep_axis=sweep_axis, aligned=request.aligned,
                prefetch=request.pipelined, extra_tiles=extras,
                stage_halos=launch, window_kind=window_kind or chosen["wk"],
                kernel=kernel, stage_taps=taps, n_inputs=n_in,
                out_bytes=out_db, device=device,
                exclude_sweep_axis=shard_axis,
            )

        def price_chain(depth: int, c: TileChoice, window_kind=None):
            """Modelled (time ms, traffic, lower bound, streaming flops,
            recompute flops) of the whole T-step chain as ceil(T/depth)
            launches of c's one tile (launch i fuses stages [i·d,
            (i+1)·d)); traffic is the reference's figure, each launch's
            input windows at the request's element width.  None when some
            launch's shared memory outgrows the budget with this tile."""
            wk = window_kind or chosen["wk"]
            budget = min(request.vmem_budget, device.smem_per_block)
            s = c.sweep_axis
            if stage_halos is None:
                smem = launch_smem("apply", work, c.tile, s, db, halo,
                                   n_inputs=n_in, pipelined=request.pipelined)
                m = launch_model("apply", work, c.tile, s, [halo],
                                 stage_points, smem, db, db, n_in, device)
                fl = chain_flops(work, c.tile, stage_points, [halo], s)
                return m["ms"], c.traffic_bytes, c.lower_bound_bytes, fl, fl
            ms = 0.0
            traffic = flops_s = flops_r = 0
            lb = 0.0
            for i in range(0, T, depth):
                launch = stage_halos[i: i + depth]
                pts = stage_points[i: i + depth]
                kernel = kernel_of(len(launch))
                in_db = stage_dbs[i - 1] if i else db
                lhalo = halo_from_offsets(
                    [st.offsets for st in stages[i: i + depth]], d)
                try:
                    smem = launch_smem(kernel, work, c.tile, s, in_db, lhalo,
                                       launch, 1, request.pipelined, wk)
                except ValueError:
                    return None
                if smem > budget or device.ctas_per_sm(kernel, smem) < 1:
                    return None
                m = launch_model(kernel, work, c.tile, s,
                                 launch if kernel == "chain" else [lhalo],
                                 pts, smem, in_db, stage_dbs[i + len(launch)
                                                            - 1], 1, device)
                ms += m["ms"]
                traffic += tile_traffic_bytes(work, c.tile, halo, db, s,
                                              stage_halos=launch)
                flops_s += chain_flops(work, c.tile, pts, launch, s,
                                       streaming=True)
                flops_r += chain_flops(work, c.tile, pts, launch, s,
                                       streaming=False)
                lb += c.lower_bound_bytes  # per-launch bound: shape + budget
            return ms, traffic, lb, flops_s, flops_r

        legacy = tiled(1)  # the default candidates, one stage a launch
        legacy_priced = price_chain(1, legacy)
        if request.strategy == "legacy":
            extras = None
            by_kind = {kinds[0]: {1: legacy}}
        else:
            extras = self._extra_candidates(work, halo, request, lattice)
            depths = range(1, min(T, _CHAIN_MAX_STAGES) + 1)
            by_kind = {}
            for wk in kinds:
                per_depth_k = {}
                for depth in depths:
                    if sum(stage_points[:depth]) > _CHAIN_MAX_TAPS \
                            and depth > 1:
                        break
                    try:
                        per_depth_k[depth] = tiled(depth, extras,
                                                   window_kind=wk)
                    except ValueError:
                        # The depth-d window and frontiers outgrew the
                        # budget; deeper ones only grow.
                        break
                by_kind[wk] = per_depth_k
            # Superset of candidates under the same model: can never lose.
            first = by_kind[kinds[0]]
            assert first[1].modeled_ms <= legacy.modeled_ms, (
                f"planner regressed vs legacy heuristic: "
                f"{first[1].modeled_ms} > {legacy.modeled_ms} ms on {work}"
            )

        scored_by_kind = {}
        for wk, per_depth_k in by_kind.items():
            sc = {}
            for depth, c in per_depth_k.items():
                priced = price_chain(depth, c, window_kind=wk)
                if priced is not None:
                    sc[depth] = priced
            assert 1 in sc, f"depth-1 chain infeasible on {work}"
            scored_by_kind[wk] = sc
        # Window-kind race: keep the modelled-fastest layout (ties go to
        # the first listed — ring under "auto").  The ring's frontiers are
        # subsets of the trapezoid's, so every trapezoid-feasible depth is
        # ring-feasible at no more shared memory: the ring never loses.
        window_kind = min(
            scored_by_kind,
            key=lambda wk: (
                min(t[0] for t in scored_by_kind[wk].values()),
                kinds.index(wk),
            ),
        )
        if wk_req == "auto" and len(scored_by_kind) > 1:
            assert window_kind == "ring", (
                f"trapezoid out-scored the ring on {work}: {scored_by_kind}"
            )
        per_depth = by_kind[window_kind]
        scored = scored_by_kind[window_kind]
        chosen["wk"] = window_kind  # rebind the closures' default
        # A heterogeneous chain prices launches with their own halos, where
        # the union-scored tile is not provably best: take the legacy tile
        # whenever it chains faster, so planned <= legacy for every input.
        if legacy_priced is not None and legacy_priced[0] < scored[1][0]:
            per_depth[1] = legacy
            scored[1] = legacy_priced
        return _Survey(
            request=request, T=T, halo=halo, stage_halos=stage_halos,
            lattice=lattice, pad=pad, work=work, work_full=work_full,
            shard_axis=shard_axis, stage_dbs=stage_dbs, extras=extras,
            legacy=legacy, legacy_priced=legacy_priced, per_depth=per_depth,
            scored=scored, tiled=tiled, price_chain=price_chain,
            window_kind=window_kind,
        )

    def _freeze(
        self, sv: "_Survey", fused_depth: int, choice: TileChoice, priced
    ) -> StencilPlan:
        """Freeze one scored (tile, depth) candidate of a survey into a full
        :class:`StencilPlan`."""
        request, T = sv.request, sv.T
        ms_total, traffic_total, lb_total, flops_total, rflops_total = priced
        sweep = choice.sweep_axis
        window = sv.halo
        if sv.stage_halos is not None and fused_depth > 1:
            window = chain_halo(sv.stage_halos[:fused_depth])
        h_s = window[sweep][0] + window[sweep][1]
        legacy_total = (
            sv.legacy_priced if sv.legacy_priced is not None
            else (T * sv.legacy.modeled_ms, T * sv.legacy.traffic_bytes)
        )
        # Sharding: the scores are the worst shard's already; what is left
        # is the exchange.  Each of the S − 1 interior boundaries moves the
        # launch's shard-axis cone over the halo'd cross extent of the
        # whole padded grid, once per launch and once per RHS, at the
        # launch input's element width (a later launch reads the previous
        # stage's output).
        grid_full = tuple(-(-n // t)
                          for n, t in zip(sv.work_full, choice.tile))
        halo_exchange = 0
        a = sv.shard_axis
        if a is not None:
            if sv.stage_halos is not None:
                cones = [chain_halo(sv.stage_halos[i: i + fused_depth])
                         for i in range(0, T, fused_depth)]
            else:
                cones = [sv.halo]
            p_rhs = max(len(request.offsets), 1)
            for li, cone in enumerate(cones):
                ext = prod(grid_full[i] * choice.tile[i] + lo + hi
                           for i, (lo, hi) in enumerate(cone) if i != a)
                in_db = (sv.stage_dbs[li * fused_depth - 1]
                         if sv.stage_dbs and li > 0 else request.dtype_bytes)
                halo_exchange += (p_rhs * (request.num_shards - 1)
                                  * (cone[a][0] + cone[a][1]) * ext * in_db)
        return StencilPlan(
            request=request,
            lattice=sv.lattice,
            pad=sv.pad,
            tile=choice.tile,
            sweep_axis=sweep,
            grid=grid_full,
            pipelined=bool(
                request.pipelined and h_s > 0 and choice.grid[sweep] > 1
            ),
            traffic_bytes=int(traffic_total),
            vmem_bytes=int(choice.vmem_bytes),
            surface_to_volume=float(choice.surface_to_volume),
            lower_bound_bytes=float(lb_total),
            efficiency=float(min(lb_total / max(traffic_total, 1), 1.0)),
            legacy_tile=sv.legacy.tile,
            legacy_sweep_axis=sv.legacy.sweep_axis,
            legacy_traffic_bytes=int(legacy_total[1]),
            time_steps=T,
            fused_depth=int(fused_depth),
            single_pass_traffic_bytes=int(sv.scored[1][1]),
            modeled_flops=int(flops_total),
            recompute_flops=int(rflops_total),
            depth_scores=tuple(
                (int(depth), int(tr), int(fs))
                for depth, (_ms, tr, _lb, fs, _fr) in sorted(sv.scored.items())
            ),
            window_kind=sv.window_kind,
            num_shards=int(request.num_shards),
            shard_axis=a,
            per_shard_traffic_bytes=int(traffic_total),
            halo_exchange_bytes=int(halo_exchange),
            modeled_ms=float(ms_total),
            kernel=choice.kernel,
            ctas_per_sm=int(choice.ctas_per_sm),
            waves=float(choice.waves),
            depth_ms=tuple(
                (int(depth), float(p[0])) for depth, p in sorted(sv.scored.items())
            ),
            legacy_modeled_ms=float(legacy_total[0]),
            single_pass_modeled_ms=float(sv.scored[1][0]),
        )

    # -- optional exact validation ----------------------------------------

    def validate(self, plan: StencilPlan, max_points: int = 400_000) -> dict:
        """Cache-simulate the padded vs. original grid (natural order) on
        the request's cache geometry — the §2 exact model as a check on the
        pad decision.  Only meaningful when the request has a geometry;
        large grids are truncated to a thin slab along the last dim."""
        if plan.request.geometry is None:
            return {"validated": False, "reason": "no cache geometry"}
        from ..core.cache_fitting import access_stream, natural_order, star_stencil
        from ..core.cache_sim import simulate_misses

        geom = CacheGeometry(*plan.request.geometry)
        halo = halo_from_offsets(plan.request.offsets, len(plan.request.shape))
        r = max(max(lo, hi) for lo, hi in halo)
        r = max(r, 1)
        K = star_stencil(len(plan.request.shape), r)

        def slab(dims):
            dims = tuple(dims)
            while prod(dims) > max_points and dims[-1] > 4 * r + 4:
                dims = dims[:-1] + (max(dims[-1] // 2, 4 * r + 4),)
            return dims

        out = {"validated": True, "geometry": plan.request.geometry}
        for name, dims in (
            ("original", plan.request.shape),
            ("padded", plan.pad.padded_shape),
        ):
            dims = slab(dims)
            pts = prod(max(n - 2 * r, 1) for n in dims)
            order = natural_order(dims, r)
            if len(order) == 0:
                out[name] = {"dims": dims, "miss_per_point": float("nan")}
                continue
            m = simulate_misses(access_stream(dims, order, K), geom)
            out[name] = {"dims": dims, "miss_per_point": m / pts}
        if plan.pad.nonzero:
            o = out["original"]["miss_per_point"]
            p = out["padded"]["miss_per_point"]
            out["miss_reduction_x"] = o / p if p else float("inf")
        return out


_DEFAULT: Planner | None = None


def _plan_span_args(plan: StencilPlan, tuned: bool) -> dict:
    """A ``plan`` span's outcome arguments."""
    return dict(
        tuned=tuned,
        tile=list(plan.tile),
        sweep_axis=plan.sweep_axis,
        fused_depth=plan.fused_depth,
        num_shards=plan.num_shards,
        traffic_bytes=plan.traffic_bytes,
        modeled_ms=plan.modeled_ms,
    )


def default_planner() -> Planner:
    """Process-wide planner with the persistent default cache — what the
    kernel layer consults when no explicit plan is passed."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Planner()
    return _DEFAULT


def plan_stencil(shape, offsets, **kw) -> StencilPlan:
    """Convenience: plan one stencil with the default planner.  ``offsets``
    may be a single (s, d) array or a per-RHS sequence."""
    return default_planner().plan(shape=shape, offsets=offsets, **kw)
