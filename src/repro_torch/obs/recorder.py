"""Process-local telemetry recorder of the port: structured spans, counters,
events.

The paper's whole argument is that cache behavior is *predictable* —
lattice geometry prices the traffic before the run — and the tune loop
closes it by measuring.  This module makes the evidence trail visible at
run time: every layer of the plan → tune → launch pipeline records
**spans** (plan, cache lookup, tune race, kernel launch, timing harness)
and **counters** (plan_cache_hit/miss, tunedb_hit/miss/degrade, launches,
modeled_bytes, modeled_flops, ring_smem_bytes, measured_ns, ...) into one
:class:`Recorder`, exported as Chrome/Perfetto ``trace_event`` JSON by
:mod:`repro_torch.obs.trace_event` and reconciled by ``python -m
repro_torch.obs.report``.

**Disabled is the default and costs one predicate check.**  The
module-level :func:`span` / :func:`event` helpers read one module
global; when no recorder is installed they return a shared singleton
null span (or ``None``) without allocating anything, so instrumented hot
paths — the warm plan-cache hit, the kernel launch loop — pay a pointer
compare.  Hot callers that would build a kwargs dict for span arguments
guard with ``if obs.enabled():`` first.  :func:`add` also accumulates
into the always-on totals of :mod:`repro_torch.obs.stages`, whose stage
timers run whether or not a recorder is installed and go into the
recorder as spans when one is.

Enabling, in precedence order (innermost wins; recorders nest):

* ``REPRO_TORCH_TRACE=path.json`` in the environment — a process-wide
  recorder installed at first ``repro_torch.obs`` import, flushed to
  ``path.json`` at interpreter exit (:func:`_activate_from_env`);
* ``with obs.recording("path.json") as rec:`` — scoped recorder, trace
  written on exit;
* ``stencil_pallas(..., trace="path.json")`` — one traced call (the
  stencil frontends wrap themselves in :func:`recording`).

A span is host time: a ``kernel_launch`` span times the enqueue, not the
kernel, which runs after it returns.  To line spans up with device time,
each span also opens a ``torch.profiler.record_function`` range of its
name when ``torch`` is already imported (the profiler bridge): a
``torch.profiler`` trace then shows which device kernels each span
launched.  This module imports nothing but the standard library.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
import time
from contextlib import contextmanager

from . import stages as _stages

__all__ = [
    "Recorder",
    "Span",
    "active",
    "add",
    "enabled",
    "event",
    "recording",
    "span",
]

_ENV = "REPRO_TORCH_TRACE"

# The single module global every disabled-path check reads.  ``None``
# means recording is off and all helpers are no-ops.
_active: "Recorder | None" = None


def _now_us() -> float:
    return time.perf_counter_ns() / 1e3


def _unix_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the tightest of a
    few bracketed readings: adding it to a ``perf_counter_ns`` stamp gives
    the Unix-ns clock that ``torch.profiler`` stamps its events on."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        t = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, t - (a + b) // 2)
    return best[1]


class _NullSpan:
    """The shared no-op span: entering, exiting, and ``set`` do nothing.
    A single module-level instance is returned by every disabled-path
    :func:`span` call, so the no-op path allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One recorded span: a named, timed region with key/value args.

    Use as a context manager (``with rec.span("plan", key=...) as sp:``);
    :meth:`set` attaches outcome args discovered mid-span (the tune
    winner, the chosen fusion depth).  Finished spans append to the
    recorder; the Chrome exporter turns them into ``ph: "X"`` complete
    events.
    """

    __slots__ = ("name", "cat", "args", "ts_us", "dur_us", "tid", "_rec",
                 "_prof_ctx")

    def __init__(self, rec: "Recorder", name: str, cat: str, args: dict):
        self.name = name
        self.cat = cat
        self.args = args
        self.ts_us = 0.0
        self.dur_us = 0.0
        self.tid = 0
        self._rec = rec
        self._prof_ctx = None

    def set(self, **args) -> "Span":
        self.args.update(args)
        return self

    def __enter__(self) -> "Span":
        self.tid = threading.get_ident()
        if self._rec.profiler_bridge and "torch" in sys.modules:
            # Bridge into the torch profiler's timeline so the device
            # kernels a span launches sit under a range of its name when
            # both are captured.  Only when torch is already imported:
            # observability never pulls in the framework.
            try:
                import torch.profiler

                ctx = torch.profiler.record_function(self.name)
                ctx.__enter__()
                self._prof_ctx = ctx
            except Exception:
                self._prof_ctx = None
        self.ts_us = _now_us()
        return self

    def __exit__(self, *exc) -> bool:
        self.dur_us = _now_us() - self.ts_us
        if self._prof_ctx is not None:
            try:
                self._prof_ctx.__exit__(*exc)
            except Exception:
                pass
            self._prof_ctx = None
        self._rec._finish(self)
        return False


class Recorder:
    """Process-local span/counter/event store for one recording session.

    Thread-safe (appends under one lock).  ``counters`` are monotone
    totals; every :meth:`add` is also sampled with a timestamp so the
    Chrome exporter can emit ``ph: "C"`` counter tracks (the always-on
    counters of :mod:`~repro_torch.obs.stages` arrive by :meth:`tally`,
    without samples).  ``t0_unix_ns`` is the recorder's start on the
    Unix-ns clock (:func:`_unix_offset_ns`).  ``path`` is where
    :meth:`write` puts the trace by default (also used by the
    ``REPRO_TORCH_TRACE`` atexit flush).  ``profiler_bridge`` opens a
    ``torch.profiler.record_function`` range around each span.
    """

    def __init__(self, path: str | None = None, profiler_bridge: bool = True):
        self.path = path
        self.profiler_bridge = bool(profiler_bridge)
        self.pid = os.getpid()
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self.counter_samples: list[tuple[float, str, int]] = []
        self.events: list[dict] = []
        t0_ns = time.perf_counter_ns()
        self.t0_us = t0_ns / 1e3
        self.t0_unix_ns = t0_ns + _unix_offset_ns()
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------

    def span(self, name: str, cat: str = "repro_torch", **args) -> Span:
        return Span(self, name, cat, args)

    def _finish(self, sp: Span) -> None:
        with self._lock:
            self.spans.append(sp)

    def add(self, name: str, value: int = 1) -> int:
        with self._lock:
            total = self.counters.get(name, 0) + int(value)
            self.counters[name] = total
            self.counter_samples.append((_now_us(), name, total))
        return total

    def tally(self, name: str, value: int = 1) -> None:
        """Bump a counter without a sample (the always-on counters)."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(value)

    def _stage_span(self, name: str, t0_ns: int, t1_ns: int, call: int,
                    parent: str | None) -> None:
        """File one closed stage (``repro_torch.obs.stages``) as a span."""
        sp = Span(self, name, "repro_torch.stage",
                  {"call": call, "parent": parent})
        sp.ts_us = t0_ns / 1e3
        sp.dur_us = (t1_ns - t0_ns) / 1e3
        sp.tid = threading.get_ident()
        self._finish(sp)

    def event(self, name: str, cat: str = "repro_torch", **args) -> None:
        with self._lock:
            self.events.append({
                "name": name,
                "cat": cat,
                "ts_us": _now_us(),
                "tid": threading.get_ident(),
                "args": args,
            })

    # -- export ------------------------------------------------------------

    def to_trace_events(self) -> dict:
        from .trace_event import to_trace_events

        return to_trace_events(self)

    def write(self, path: str | None = None) -> str:
        from .trace_event import write_trace

        return write_trace(self, path or self.path)


# -- module-level no-op-able helpers ----------------------------------------


def active() -> Recorder | None:
    """The currently installed recorder, or ``None`` when disabled."""
    return _active


def enabled() -> bool:
    """One predicate check — the guard hot paths use before building
    span kwargs."""
    return _active is not None


def span(name: str, cat: str = "repro_torch", **args):
    """A span on the active recorder, or the shared null span when
    recording is disabled (no allocation on that path when called with
    no keyword args — hot callers guard kwargs with :func:`enabled`)."""
    rec = _active
    if rec is None:
        return NULL_SPAN
    return rec.span(name, cat, **args)


def add(name: str, value: int = 1) -> None:
    """Bump a counter in the always-on totals and on the active recorder,
    if any."""
    _stages.add_named(name, value)
    rec = _active
    if rec is None:
        return
    rec.add(name, value)


def event(name: str, cat: str = "repro_torch", **args) -> None:
    """Record an instant event on the active recorder; no-op when
    disabled (guard kwargs with :func:`enabled` on hot paths)."""
    rec = _active
    if rec is None:
        return
    rec.event(name, cat, **args)


def _install(rec: Recorder | None) -> Recorder | None:
    """Swap the active recorder, returning the previous one."""
    global _active
    prev = _active
    _active = rec
    _stages._rec = rec
    return prev


@contextmanager
def recording(path: str | None = None, profiler_bridge: bool = True):
    """Scoped recording: install a fresh :class:`Recorder`, yield it, and
    on exit write the trace to ``path`` (when given) and restore whatever
    recorder — possibly none — was active before.  Nests: an inner
    ``recording`` shadows an outer one (spans go to the innermost)."""
    rec = Recorder(path=path, profiler_bridge=profiler_bridge)
    prev = _install(rec)
    try:
        yield rec
    finally:
        _install(prev)
        if path is not None:
            rec.write(path)


# -- REPRO_TORCH_TRACE env activation ---------------------------------------

_env_recorder: Recorder | None = None


def _flush_env_recorder() -> None:
    """atexit hook for the ``REPRO_TORCH_TRACE`` recorder: write the trace
    once at interpreter exit (idempotent; safe to call early in tests)."""
    global _env_recorder
    rec, _env_recorder = _env_recorder, None
    if rec is not None:
        if _active is rec:
            _install(None)
        rec.write()


def _activate_from_env() -> Recorder | None:
    """Install a process-wide recorder when ``REPRO_TORCH_TRACE=path.json``
    is set (called at first ``repro_torch.obs`` import).  Returns the
    recorder, or ``None`` when the variable is unset or a recorder is
    already active.  The JAX package reads ``REPRO_TRACE``, a variable of
    its own, so a process importing both never flushes two traces to one
    path."""
    global _env_recorder
    path = os.environ.get(_ENV)
    if not path or _active is not None:
        return None
    _env_recorder = Recorder(path=path)
    _install(_env_recorder)
    atexit.register(_flush_env_recorder)
    return _env_recorder
