"""Fault tolerance for 1000+-node jobs (DESIGN.md §6).

Three cooperating pieces, all unit-testable on CPU:

* ``HeartbeatTracker`` — hosts report (host_id, step, t); the coordinator
  classifies hosts as healthy / straggling / dead from configurable
  multiples of the median step time (straggler mitigation is detection +
  replacement, the standard TPU approach — there is no per-op work
  stealing on a synchronous SPMD program).
* ``StragglerPolicy`` — decides between WAIT (transient), EVICT+replace
  (persistent straggler), and RESTART_FROM_CKPT (dead host), and computes
  the step-time budget for async checkpointing cadence.
* ``plan_elastic_remesh`` — given a new world size, produces the target
  mesh shape and the resharding plan (which checkpoint axes change).
  Because checkpoints store *logical* arrays (see checkpoint/), restore
  onto the new mesh is a pure re-placement; train.py consumes the plan.

The actual transport (GRPC, etc.) is environment-specific and injected;
here the tracker is driven by explicit ``report()`` calls, which is also
how the tests drive it.

A copy of the JAX package's ``runtime/fault_tolerance.py`` (which imports
no jax): the port's trainer calls :meth:`ClusterMonitor.tick` each step.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional


class HostState(str, Enum):
    HEALTHY = "healthy"
    STRAGGLER = "straggler"
    DEAD = "dead"


class Action(str, Enum):
    CONTINUE = "continue"
    WAIT = "wait"
    EVICT = "evict"
    RESTART_FROM_CKPT = "restart_from_ckpt"


@dataclass
class HeartbeatTracker:
    straggler_factor: float = 2.0   # × median step time ⇒ straggler
    dead_factor: float = 6.0        # × median ⇒ presumed dead
    min_history: int = 4
    _last: dict[int, tuple[int, float]] = field(default_factory=dict)
    _durations: list[float] = field(default_factory=list)

    def report(self, host: int, step: int, t: Optional[float] = None):
        t = time.monotonic() if t is None else t
        prev = self._last.get(host)
        if prev is not None and step > prev[0]:
            self._durations.append((t - prev[1]) / (step - prev[0]))
            if len(self._durations) > 512:
                self._durations = self._durations[-256:]
        self._last[host] = (step, t)

    def median_step_time(self) -> Optional[float]:
        if len(self._durations) < self.min_history:
            return None
        return statistics.median(self._durations)

    def classify(self, now: Optional[float] = None) -> dict[int, HostState]:
        now = time.monotonic() if now is None else now
        med = self.median_step_time()
        out = {}
        for host, (_, t) in self._last.items():
            if med is None:
                out[host] = HostState.HEALTHY
            elif now - t > self.dead_factor * med:
                out[host] = HostState.DEAD
            elif now - t > self.straggler_factor * med:
                out[host] = HostState.STRAGGLER
            else:
                out[host] = HostState.HEALTHY
        return out


@dataclass
class StragglerPolicy:
    wait_budget_steps: float = 3.0   # tolerate this many median-steps
    spare_hosts: int = 0

    def decide(self, states: dict[int, HostState]) -> Action:
        dead = [h for h, s in states.items() if s == HostState.DEAD]
        strag = [h for h, s in states.items() if s == HostState.STRAGGLER]
        if dead:
            return (
                Action.EVICT if self.spare_hosts >= len(dead)
                else Action.RESTART_FROM_CKPT
            )
        if strag:
            return Action.WAIT if len(strag) <= 1 else Action.EVICT
        return Action.CONTINUE

    def checkpoint_interval(self, step_time_s: float, mtbf_s: float = 3600.0,
                            write_time_s: float = 30.0) -> int:
        """Young's formula: optimal interval ≈ sqrt(2·write·MTBF)."""
        opt_s = (2.0 * write_time_s * mtbf_s) ** 0.5
        return max(1, int(opt_s / max(step_time_s, 1e-6)))


@dataclass
class ElasticPlan:
    old_mesh: tuple[int, ...]
    new_mesh: tuple[int, ...]
    axis_names: tuple[str, ...]
    batch_per_host_changed: bool
    note: str


def plan_elastic_remesh(
    world: int, model_parallel: int = 16, pods: int = 1
) -> ElasticPlan:
    """Shrink/grow only the data axis — TP degree is checkpoint-invariant
    here (logical arrays), but keeping it fixed also keeps per-layer
    communication volume fixed, so step time scales predictably."""
    if world % (model_parallel * pods):
        raise ValueError(
            f"world {world} not divisible by model×pods {model_parallel}×{pods}"
        )
    data = world // (model_parallel * pods)
    if data < 1:
        raise ValueError("not enough hosts for one data row")
    shape = (pods, data, model_parallel) if pods > 1 else (data, model_parallel)
    names = ("pod", "data", "model") if pods > 1 else ("data", "model")
    return ElasticPlan(
        old_mesh=(), new_mesh=shape, axis_names=names,
        batch_per_host_changed=True,
        note=(
            "restore checkpoint with new shardings (logical arrays reshard "
            "freely); data pipeline re-slices global batch by new host count"
        ),
    )


@dataclass
class ClusterMonitor:
    """Glue object used by train.py: feed heartbeats, ask for an action."""

    tracker: HeartbeatTracker = field(default_factory=HeartbeatTracker)
    policy: StragglerPolicy = field(default_factory=StragglerPolicy)

    def tick(self, host: int, step: int, t: Optional[float] = None) -> Action:
        self.tracker.report(host, step, t)
        return self.policy.decide(self.tracker.classify(t))
