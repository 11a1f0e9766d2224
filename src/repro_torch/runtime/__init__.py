"""Runtime support of the port: the measurement harness and the
trainer's fault tolerance (a copy of the JAX package's jax-free
``runtime/fault_tolerance.py``).

The JAX package's ISA-control module comes with ``ROADMAP.md`` queue A
item 13b."""

from .fault_tolerance import (  # noqa: F401
    Action,
    ClusterMonitor,
    ElasticPlan,
    HeartbeatTracker,
    HostState,
    StragglerPolicy,
    plan_elastic_remesh,
)
from .timing import TimingResult, device_fingerprint, measure  # noqa: F401

__all__ = [
    "Action",
    "ClusterMonitor",
    "ElasticPlan",
    "HeartbeatTracker",
    "HostState",
    "StragglerPolicy",
    "TimingResult",
    "device_fingerprint",
    "measure",
    "plan_elastic_remesh",
]
