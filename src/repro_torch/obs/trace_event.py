"""Chrome/Perfetto ``trace_event`` JSON export for
:class:`~repro_torch.obs.Recorder` (the JAX package's schema, unchanged).

One recorder session becomes one JSON object in the Trace Event Format
(the ``chrome://tracing`` / Perfetto "JSON object" flavor):

* spans       → ``ph: "X"`` complete events (``ts``/``dur`` in µs),
* counters    → ``ph: "C"`` counter samples (one track per counter name),
* events      → ``ph: "i"`` instant events,
* plus ``ph: "M"`` process/thread metadata so the timeline is labeled.

Timestamps are rebased to the recorder's start so traces begin near 0;
``otherData.t0_unix_ns`` is that start on the Unix-ns clock that
``torch.profiler`` stamps its events on, so a span's ``ts`` (µs) sits at
``t0_unix_ns + 1000 * ts`` there.
:func:`validate_trace` is the schema check the CI obs smoke and the
report CLI share (the port's trace files also pass the JAX package's
own check): it asserts the structural invariants Perfetto relies
on (``traceEvents`` list, every event has ``ph``/``name``/``pid``/``tid``,
``X`` events carry numeric ``ts`` and ``dur``), raising ``ValueError``
with a pointed message on the first violation.
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .recorder import Recorder

__all__ = ["load_trace", "to_trace_events", "validate_trace", "write_trace"]

_REQUIRED_PH = ("X", "C", "i", "I", "M", "B", "E")


def to_trace_events(rec: "Recorder") -> dict[str, Any]:
    """Render a recorder as a Chrome ``trace_event`` JSON object."""
    pid = rec.pid
    t0 = rec.t0_us
    events: list[dict[str, Any]] = [
        {
            "ph": "M",
            "name": "process_name",
            "pid": pid,
            "tid": 0,
            "args": {"name": "repro_torch stencil pipeline"},
        }
    ]
    tids = sorted(
        {sp.tid for sp in rec.spans} | {ev["tid"] for ev in rec.events}
    )
    for n, tid in enumerate(tids):
        events.append({
            "ph": "M",
            "name": "thread_name",
            "pid": pid,
            "tid": tid,
            "args": {"name": f"thread-{n}"},
        })
    for sp in rec.spans:
        events.append({
            "ph": "X",
            "name": sp.name,
            "cat": sp.cat,
            "pid": pid,
            "tid": sp.tid,
            "ts": round(sp.ts_us - t0, 3),
            "dur": round(sp.dur_us, 3),
            "args": sp.args,
        })
    for ev in rec.events:
        events.append({
            "ph": "i",
            "s": "p",
            "name": ev["name"],
            "cat": ev["cat"],
            "pid": pid,
            "tid": ev["tid"],
            "ts": round(ev["ts_us"] - t0, 3),
            "args": ev["args"],
        })
    for ts_us, name, total in rec.counter_samples:
        events.append({
            "ph": "C",
            "name": name,
            "cat": "repro_torch.counter",
            "pid": pid,
            "tid": 0,
            "ts": round(ts_us - t0, 3),
            "args": {name: total},
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "repro_torch.obs",
            "t0_unix_ns": int(rec.t0_unix_ns),
            "counters": dict(sorted(rec.counters.items())),
        },
    }


def write_trace(rec: "Recorder", path: str) -> str:
    """Serialize ``rec`` to ``path`` as trace_event JSON; returns the path."""
    if not path:
        raise ValueError("write_trace: no output path given")
    doc = to_trace_events(rec)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1, default=str)
        fh.write("\n")
    return path


def validate_trace(doc: Any) -> dict[str, Any]:
    """Assert ``doc`` is structurally valid trace_event JSON.

    Returns the document for chaining; raises ``ValueError`` naming the
    first offending event otherwise.
    """
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace: expected a JSON object with 'traceEvents'")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("trace: 'traceEvents' must be a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"trace: event #{i} is not an object")
        ph = ev.get("ph")
        if ph not in _REQUIRED_PH:
            raise ValueError(f"trace: event #{i} has unknown ph={ph!r}")
        for field in ("name", "pid", "tid"):
            if field not in ev:
                raise ValueError(
                    f"trace: event #{i} ({ev.get('name')!r}) missing {field!r}"
                )
        if ph == "X":
            for field in ("ts", "dur"):
                if not isinstance(ev.get(field), (int, float)):
                    raise ValueError(
                        f"trace: complete event #{i} ({ev['name']!r}) has "
                        f"non-numeric {field!r}"
                    )
    return doc


def load_trace(path: str) -> dict[str, Any]:
    """Read and validate a trace file written by :func:`write_trace`."""
    with open(path) as fh:
        doc = json.load(fh)
    return validate_trace(doc)
