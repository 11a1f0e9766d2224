"""Always-on stage timers and process-wide totals of the port's stencil call.

Every port call (``stencil_pallas`` / ``stencil_iterate`` /
``ir.run_program`` → ``multi_stencil_pallas``) is one root stage,
``stencil_call``, with these stages under it:

* ``frontend``: the call memo's key and lookup (counters
  ``call_memo.hit`` / ``call_memo.miss``: a hit goes from there to its
  bound launches, through an empty ``decide`` and each launch's
  ``launch_buffers`` and ``sweep_launch``); else ``_as_tensors``, dtype
  resolution, the program's build, ``ir.lower`` and the static specs;
* ``decide``: the launch decision (``validate_plan_call`` or
  ``_auto_tile``: signature, tuner, plan memo) up to the resolved tile;
* ``launch_buffers``: each launch's geometry and, for a chain launch,
  its ``embed_inputs`` (the fill, the copy-in, any wrap bands; a sharded
  launch's scatter and halo exchange); a plain application reads the
  caller's grid and builds no buffer (counter ``launch_buffers.direct``);
* ``sweep_launch``: the ``sweep_apply`` / ``sweep_chain`` wrapper (checks,
  the launch-table key and lookup, the output's allocation, the launch);
  an apply launch on the card counts the row path its launcher returns
  (``apply_rows.copy16``: every window row took the flat 16-byte copy;
  ``apply_rows.span``: those rows were also widened to copy the blocks
  around their end pieces; ``apply_rows.pair``: the bf16 kernel computed
  two neighbouring outputs a thread);
* ``trim``: the slice of a padded result back to the grid (a sharded
  launch's gather); a launch on the caller's grid has none.

A stage's time is host time: on the card the work it enqueues runs after
it returns.  Its self time is its time less its child stages'.  A call
made while another is open (a tune race's launches) belongs to the open
call.

The totals are kept whether or not a recorder is installed, for the
operator's view (:func:`totals`): per stage the count, nanoseconds and
self nanoseconds, and the counters of :data:`COUNTERS`, each over all
calls and split into **warm** and **cold** calls (a call is cold when a
cache on its path missed during it: the call memo, the planner's memo,
the plan cache, the tuned DB, the launch tables, a kernel library's load
or build).  The hot path takes no lock, opens no profiler range and
allocates nothing but the int objects it replaces; the totals are one
thread's view (calls from several threads at once are filed under
whichever call is open).  With a recorder installed, each stage also
becomes one span in it, carrying only ``call`` (the call's id) and
``parent`` (the enclosing stage's name).
"""

from __future__ import annotations

import time
from array import array

__all__ = [
    "COUNTERS",
    "STAGES",
    "call",
    "count",
    "counter",
    "mark_cold",
    "reset_totals",
    "stage",
    "totals",
]

_ns = time.perf_counter_ns

STAGES = ("stencil_call", "frontend", "decide", "launch_buffers",
          "sweep_launch", "trim")
COUNTERS = (
    "calls", "cold_calls",
    "plan_memo_hit", "plan_memo_miss",
    "launch_table_hit", "launch_table_miss",
    "device_ops.fill", "device_ops.copy_in", "device_ops.wrap",
    "device_ops.kernel", "device_ops.trim",
    "launches.sweep_apply", "launches.sweep_chain", "launches.conv1d",
    "launch_buffers.direct", "apply_rows.copy16", "apply_rows.span",
    "apply_rows.pair",
    "call_memo.hit", "call_memo.miss",
)
# One slot a counter, then three a stage: its count, its ns, and the ns
# of the stages closed directly inside it (its self time is the difference).
_KEYS = COUNTERS + tuple(
    f"{s}.{k}" for s in STAGES for k in ("n", "ns", "child_ns"))
_SLOT = {k: i for i, k in enumerate(_KEYS)}
_N = len(_KEYS)
_BASE = tuple(len(COUNTERS) + 3 * i for i in range(len(STAGES)))
_ROOT = _BASE[0]
_CALLS = _SLOT["calls"]
_COLD_CALLS = _SLOT["cold_calls"]

_all = [0] * _N       # every call, and work outside any call
_cold = [0] * _N      # cold calls
_outside = [0] * _N   # work done outside any call (a kernel called directly)
_start = [0] * _N     # ``_all`` as the open call began
# ``obs.add`` counters without a slot, by name, as machine integers: a
# bump keeps no new object alive.
_extra_slot: dict = {}
_extra = array("q")

# The open stages, innermost last: their first total's slot and start ns.
_MAX = 256
_st_base = [0] * _MAX
_st_t0 = [0] * _MAX
_depth = 0
_call_depth = [0] * _MAX  # the stage depth each open call began at
_open = 0                 # open calls: 1 is a root call, more are nested
_is_cold = False
_call_id = 0
_rec = None               # the active recorder, set by ``recorder._install``


def _close(d: int, t1: int) -> None:
    """Close the stage at depth ``d``, the innermost, at ``t1`` ns."""
    global _depth
    _depth = d
    b = _st_base[d]
    dur = t1 - _st_t0[d]
    _all[b] += 1
    _all[b + 1] += dur
    if d:
        _all[_st_base[d - 1] + 2] += dur
    if not _open:
        _outside[b] += 1
        _outside[b + 1] += dur
        if d:
            _outside[_st_base[d - 1] + 2] += dur
    if _rec is not None:
        _rec._stage_span(_NAME[b], _st_t0[d], t1, _call_id,
                         _NAME[_st_base[d - 1]] if d else None)


class Stage:
    """One stage's timer: ``with stage:``, or ``stage.begin()`` …
    ``stage.end()`` (``a.then(b)`` ends ``a`` and begins ``b`` at one
    instant); one shared instance a stage (:func:`stage`)."""

    __slots__ = ("base", "name")

    def __init__(self, index: int, name: str):
        self.base = _BASE[index]
        self.name = name

    def begin(self) -> "Stage":
        global _depth
        d = _depth
        _depth = d + 1
        _st_base[d] = self.base
        _st_t0[d] = _ns()
        return self

    def end(self, et=None, ev=None, tb=None) -> bool:
        """Close this stage, and any stage an exception left open inside
        it; also the context manager's exit."""
        global _depth
        t1 = _ns()
        d = _depth - 1
        b = self.base
        if _st_base[d] != b or _rec is not None or not _open:
            _end_slow(d, b, t1)
            return False
        # _close, inline: the innermost stage, inside a call, unrecorded.
        _depth = d
        dur = t1 - _st_t0[d]
        _all[b] += 1
        _all[b + 1] += dur
        if d:
            _all[_st_base[d - 1] + 2] += dur
        return False

    def then(self, other: "Stage") -> "Stage":
        """End this stage, the innermost, and begin ``other`` as it ends."""
        t = _ns()
        d = _depth - 1
        b = self.base
        if _st_base[d] != b or _rec is not None or not _open:
            _end_slow(d, b, t)
            return other.begin()
        dur = t - _st_t0[d]
        _all[b] += 1
        _all[b + 1] += dur
        if d:
            _all[_st_base[d - 1] + 2] += dur
        _st_base[d] = other.base
        _st_t0[d] = t
        return other

    __enter__ = begin
    __exit__ = end


def _end_slow(d: int, b: int, t1: int) -> None:
    """Close the innermost stage whose first slot is ``b``, at or inside
    depth ``d``, with any left open inside it; nothing if none is open."""
    while d > 0 and _st_base[d] != b:
        d -= 1
    if d >= 0 and _st_base[d] == b:
        while _depth - 1 > d:
            _close(_depth - 1, t1)
        _close(d, t1)


_NAME = {b: name for b, name in zip(_BASE, STAGES)}
_STAGE_OBJ = {name: Stage(i, name) for i, name in enumerate(STAGES)}


def stage(name: str) -> Stage:
    """The shared timer of stage ``name`` (one of :data:`STAGES`)."""
    return _STAGE_OBJ[name]


class _Call:
    """The root stage of a port call (``with obs.call():``).  A call made
    while another is open belongs to it: it opens no root, but any stage
    it leaves open is closed when it returns."""

    __slots__ = ()

    def __enter__(self) -> "_Call":
        global _open, _is_cold, _call_id, _depth
        n = _open
        d = _depth
        _call_depth[n] = d
        _open = n + 1
        if n:
            return self
        _start[:] = _all
        _is_cold = False
        _call_id += 1
        _all[_CALLS] += 1
        _depth = d + 1
        _st_base[d] = _ROOT
        _st_t0[d] = _ns()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        global _open, _depth
        t1 = _ns()
        n = _open - 1
        base = _call_depth[n]
        if n:
            while _depth > base:  # stages an exception left open
                _close(_depth - 1, t1)
            _open = n
            return False
        if _depth != base + 1 or _rec is not None:
            while _depth > base:
                _close(_depth - 1, t1)
        else:  # _close of the root, inline
            _depth = base
            _all[_ROOT] += 1
            _all[_ROOT + 1] += t1 - _st_t0[base]
            if base:
                _all[_st_base[base - 1] + 2] += t1 - _st_t0[base]
        if _is_cold:
            _all[_COLD_CALLS] += 1
            for i in range(_N):
                _cold[i] += _all[i] - _start[i]
        _open = 0
        return False


_CALL = _Call()


def call() -> _Call:
    """The root stage ``stencil_call``, for ``with obs.call():``."""
    return _CALL


def counter(name: str) -> int:
    """The slot of counter ``name`` (one of :data:`COUNTERS`), for
    :func:`count`."""
    return _SLOT[name]


def count(slot: int, value: int = 1) -> None:
    """Add ``value`` to the counter in ``slot`` (:func:`counter`), and to
    the active recorder's counters (without a sample)."""
    _all[slot] += value
    if not _open:
        _outside[slot] += value
    rec = _rec
    if rec is not None:
        rec.tally(_KEYS[slot], value)


def mark_cold() -> None:
    """A cache on the open call's path missed: the call is cold."""
    global _is_cold
    _is_cold = True


def add_named(name: str, value: int) -> None:
    """Accumulate an ``obs.add`` counter into the totals."""
    i = _extra_slot.get(name)
    if i is None:
        i = _extra_slot[name] = len(_extra)
        _extra.append(0)
    _extra[i] += value


def _named(vals) -> dict:
    """The slotted totals ``vals`` by key, each stage's ``child_ns`` given
    as its ``self_ns``."""
    out = {}
    for i, k in enumerate(_KEYS):
        if k.endswith(".child_ns"):
            stage_ = k[: -len(".child_ns")]
            out[f"{stage_}.self_ns"] = vals[i - 1] - vals[i]
        else:
            out[k] = vals[i]
    return out


def totals() -> dict:
    """A copy of the process-wide totals: each counter of
    :data:`COUNTERS` and of ``obs.add`` by name, and each stage's
    ``<stage>.n``, ``<stage>.ns`` and ``<stage>.self_ns`` (its ns less its
    child stages'), over all calls and work outside them; ``"warm"`` and
    ``"cold"`` hold the same over warm and over cold calls alone."""
    out = {k: _extra[i] for k, i in _extra_slot.items()}
    for k, v in _named(_all).items():
        out[k] = out.get(k, 0) + v
    out["warm"] = _named([a - c - o for a, c, o in zip(_all, _cold,
                                                          _outside)])
    out["cold"] = _named(_cold)
    return out


def reset_totals() -> None:
    """Zero the totals (not the open stages)."""
    for buf in (_all, _cold, _outside, _start):
        buf[:] = [0] * _N
    _extra[:] = array("q", bytes(8 * len(_extra)))
