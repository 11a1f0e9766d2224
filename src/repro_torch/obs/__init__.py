"""Zero-dependency telemetry of the port's plan → tune → launch pipeline.

Public API (all safe to call with recording disabled — one predicate
check, no allocation):

* ``obs.enabled()`` / ``obs.active()`` — is a recorder installed?
* ``obs.span(name, **args)`` — context-managed timed region (host time),
* ``obs.add(name, value)`` — bump a counter,
* ``obs.event(name, **args)`` — instant event,
* ``obs.recording(path)`` — scoped recorder, trace written on exit,
* ``Recorder`` — the span/counter/event store itself,
* ``obs.call()`` / ``obs.stage(name)`` / ``obs.count(obs.counter(name))``
  / ``obs.mark_cold()`` — the always-on stage timers and counters of the
  stencil call (:mod:`repro_torch.obs.stages`), read by ``obs.totals()``
  whether or not a recorder is installed.

Setting ``REPRO_TORCH_TRACE=path.json`` before this package is first
imported installs a process-wide recorder flushed at interpreter exit.
Traces are Chrome/Perfetto ``trace_event`` JSON
(:mod:`repro_torch.obs.trace_event`) and reconcile with ``python -m
repro_torch.obs.report``.
"""

from .recorder import (  # noqa: F401
    NULL_SPAN,
    Recorder,
    Span,
    _activate_from_env,
    active,
    add,
    enabled,
    event,
    recording,
    span,
)
from .stages import (  # noqa: F401
    call,
    count,
    counter,
    mark_cold,
    reset_totals,
    stage,
    totals,
)
from .trace_event import (  # noqa: F401
    load_trace,
    to_trace_events,
    validate_trace,
    write_trace,
)

__all__ = [
    "NULL_SPAN",
    "Recorder",
    "Span",
    "active",
    "add",
    "call",
    "count",
    "counter",
    "enabled",
    "event",
    "load_trace",
    "mark_cold",
    "recording",
    "reset_totals",
    "span",
    "stage",
    "to_trace_events",
    "totals",
    "validate_trace",
    "write_trace",
]

_activate_from_env()
