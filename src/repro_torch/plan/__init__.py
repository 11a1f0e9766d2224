"""Stencil plan compiler of the port: lattice → padding → tiling, scored by
the Hopper cost model, compiled once, cached forever.

The paper's pipeline (interference lattice → LLL → unfavorable-grid
detection → padding → tile search) is one ``Planner.plan()`` call producing
a frozen :class:`StencilPlan`, memoized by a content-addressed persistent
:class:`PlanCache` (its own directory, never the JAX package's).  The
kernel frontends (``kernels.stencil`` with ``tile=None``, ``plan=`` or
``vmem_budget=``, and ``kernels.conv1d`` with ``tile_s=None``) treat the
plan as the single source of truth for tile, sweep axis, fusion depth and
window kind.

``python -m repro_torch.plan.explain SHAPE`` prints a plan report.  The
reference's measured tune loop (``AutoTuner``, ``TunedPlanDB``) is not in
the port yet (``ROADMAP.md`` queue A, item 9).
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

__all__ = [
    "PLANNER_VERSION",
    "LatticeReport",
    "PadPlan",
    "PlanCache",
    "PlanMismatchError",
    "PlanRequest",
    "Planner",
    "StageSpec",
    "StencilPlan",
    "default_cache_dir",
    "default_planner",
    "plan_stencil",
    "validate_plan_call",
]
