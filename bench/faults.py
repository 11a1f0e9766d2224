"""Broken versions of the timed path, which the check has to catch.

Each is an ``entry(cell, taps, weights, device)`` for
:func:`bench.harness.run_cell`, wrapping the port's own call:

* ``unchanged`` — a step that returns its state unchanged;
* ``stale``     — each call returns the output of the call before it (a
  launch buffer not refreshed); the first returns its own;
* ``half``      — half of the grid left out: the upper half of the first
  axis keeps its input values;
* ``skip_half`` — half of the batch left out: every other call returns
  its block unchanged (the many-block mix's batch is its blocks);
* ``altered``   — one answer altered where it is produced: the output's
  middle point moved by 1% of the output's largest magnitude;
* ``mirrored``  — the port handed every tap's offset negated, so that it
  applies ``w(o)`` at ``-o``.

There is no exchange between cards to leave out: every cell runs on one.
"""

from __future__ import annotations

from .harness import port_entry

KINDS = ("unchanged", "stale", "half", "skip_half", "altered", "mirrored")


def entry(kind: str):
    if kind not in KINDS:
        raise ValueError(f"unknown fault {kind!r}; one of {KINDS}")

    def make(cell, taps, weights, device):
        if kind == "mirrored":
            flipped = [tuple(-v for v in o) for o in taps]
            return port_entry(cell, flipped, weights, device)
        call = port_entry(cell, taps, weights, device)
        if kind == "unchanged":
            return lambda u: u
        if kind == "stale":
            last = []

            def broken(u):
                out = call(u)
                last.append(out)
                return last.pop(0) if len(last) > 1 else out
        elif kind == "half":
            def broken(u):
                out = call(u)
                h = u.shape[0] // 2
                out[h:] = u[h:]
                return out
        elif kind == "skip_half":
            count = [0]

            def broken(u):
                count[0] += 1
                return call(u) if count[0] % 2 else u
        else:
            def broken(u):
                out = call(u)
                mid = tuple(n // 2 for n in out.shape)
                out[mid] += 0.01 * out.abs().max()
                return out
        return broken

    return make
