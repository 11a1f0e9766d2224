"""Stencil plan compiler of the port: lattice → padding → tiling, scored by
the Hopper cost model, compiled once, cached forever — and, on request,
measured.

The paper's pipeline (interference lattice → LLL → unfavorable-grid
detection → padding → tile search) is one ``Planner.plan()`` call producing
a frozen :class:`StencilPlan`, memoized by a content-addressed persistent
:class:`PlanCache` (its own directory, never the JAX package's).  The
kernel frontends (``kernels.stencil`` with ``tile=None``, ``plan=``,
``vmem_budget=`` or ``tune=``, and ``kernels.conv1d`` with
``tile_s=None``) treat the plan as the single source of truth for tile,
sweep axis, fusion depth and window kind.

The measured tune loop (:class:`AutoTuner`) races the planner's top
candidates on the device and keeps the winner in a :class:`TunedPlanDB`
keyed by the request and :func:`backend_fingerprint`.

``python -m repro_torch.plan.explain SHAPE`` prints a plan report (with
``--tuned``, the stored measured table); ``python -m
repro_torch.plan.tune SHAPE`` measures one.
"""

from .cache import PlanCache, default_cache_dir  # noqa: F401
from .planner import Planner, default_planner, plan_stencil  # noqa: F401
from .schema import (  # noqa: F401
    PLANNER_VERSION,
    LatticeReport,
    PadPlan,
    PlanMismatchError,
    PlanRequest,
    StageSpec,
    StencilPlan,
    validate_plan_call,
)
from .tune import AutoTuner, default_tuner, resolve_tuner  # noqa: F401
from .tunedb import (  # noqa: F401
    TUNEDB_SCHEMA,
    CandidateTiming,
    TunedPlanDB,
    TuneRecord,
)

__all__ = [
    "PLANNER_VERSION",
    "TUNEDB_SCHEMA",
    "AutoTuner",
    "CandidateTiming",
    "LatticeReport",
    "PadPlan",
    "PlanCache",
    "PlanMismatchError",
    "PlanRequest",
    "Planner",
    "StageSpec",
    "StencilPlan",
    "TuneRecord",
    "TunedPlanDB",
    "default_cache_dir",
    "default_planner",
    "default_tuner",
    "plan_stencil",
    "resolve_tuner",
    "validate_plan_call",
]
