"""One run of one benchmark cell: set-up, the closed loop, the check.

A cell of ``BENCHMARK.json`` names a configuration (``file``: the
operator, dtype, boundary, weight rule, the check's limit and its
control's precision) and a traffic mix (``bench/mixes/<traffic>.json``:
grid, entry, time steps per call, blocks, calls per request, calls
checked in the window and on fresh grids).  :func:`load_cell` resolves
both by name, :func:`run_cell` runs them through the mix's entry
(``bench/entries/<entry>.py``, a ``make(config, mix, taps, weights,
device)`` that returns the call), and each metric of the cell is read
from the run's record by its own reader,
``bench/metrics/<metric>.py`` (or ``<base>.py`` for a metric named
``<base>.<qualifier>``), a ``read(rec)`` that returns a number or
``None`` (nothing to read: the metric is left out of the line).

The record ``rec`` a reader gets:

* ``config``, ``mix``: the two files' contents;
* ``setup_s``: process start to the window's opening (its phases are
  in the result's ``setup_phases_s``);
* ``window_s``: the window's opening to the last request's end, less
  the pauses in which the check's sample was copied to the host;
* ``requests``: per request ``(start, sync_start, end)``, ``perf_counter``
  ns: the first call's entry, the ``synchronize()`` call, its return;
* ``calls``: per port call ``(entry, return)``, the same clock;
* ``points_per_call``, ``steps_per_call``; ``work``: one call's bytes,
  flops and least seconds (``bench/roofline.py``);
* ``peak_bytes``: ``torch.cuda.max_memory_allocated()`` over the window
  (``None`` off the card);
* ``trace``: ``None`` untraced, else :func:`bench.trace.summarize`'s
  dict (``busy_s``, ``n_ops``, ``ops``, ``idle``, ``aligned``).

Nothing here imports ``jax``, ``jaxlib`` or the JAX package ``repro``, and
the port is imported only inside the functions that drive it.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from . import roofline, trace
from .reference import stencil as reference

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
WARM_REQUESTS = 3
FRESH_STREAM = 0x9E3779B97F4A7C15  # the fresh grids' seed, apart


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``root``'s manifest: its workload entry, its
    configuration and mix files' contents, and the end-to-end and
    per-layer metric entries it reports."""
    root = Path(root)
    manifest = load_manifest(root)
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise KeyError(
            f"no workload {name!r} in BENCHMARK.json (has: "
            f"{', '.join(sorted(by_name))})"
        )
    work = by_name[name]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[work["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    mix = json.loads(
        (root / "bench" / "mixes" / f"{work['traffic']}.json").read_text()
    )

    def reported(entries):
        return [m for m in entries if name in m.get("workloads", [name])]

    return {
        "name": name,
        "chips": int(work["chips"]),
        "config": config,
        "mix": mix,
        "end_to_end": reported(manifest["end_to_end"]),
        "per_layer": reported(manifest["per_layer"]),
        "root": str(root),
    }


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str, root: Path = ROOT):
    """The ``read(rec)`` function of ``bench/metrics/<metric>.py``; a
    metric named ``<base>.<qualifier>`` without a file of its own is read
    by ``<base>.py`` (one quantity split by the end-to-end metric it
    moves, such as ``host_ms_per_call.blocks``)."""
    metrics = Path(root) / "bench" / "metrics"
    path = metrics / f"{metric}.py"
    if not path.exists():
        path = metrics / f"{metric.split('.')[0]}.py"
    safe = metric.replace(".", "_").replace("-", "_")
    return _module(path, f"bench_metric_{safe}").read


def forbidden_modules(names=None) -> list[str]:
    """The top-level names among ``names`` (default: the loaded modules)
    that are JAX's or the JAX package's, compared whole: ``repro_torch``
    is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def _pairs(taps):
    """Each tap's pair of opposite taps, as the pair's first-sorted member."""
    return [min(tuple(o), tuple(-v for v in o)) for o in taps]


def zero_drift_weights(taps, rng) -> list[float]:
    """Non-negative weights summing to 1 whose first moment is zero on
    every axis (``sum_o o * w(o) = 0``), and that differ between opposite
    taps wherever the taps leave room for it.  Each pair ``{o, -o}`` draws
    a mean in [0.5, 1) and an odd part ``a``, ``w(o) = mean + a(o)``,
    ``w(-o) = mean - a(o)``; ``a`` is drawn uniform in [-1, 1), projected
    onto the odd parts with no first moment (``sum_p o_p a_p = 0``: for the
    13-point star ``a(2e) = -a(e) / 2`` on each axis), and scaled so that
    the largest ``|a|`` is half its pair's mean.  So a time loop under zero
    fill neither drifts into a wall nor decays faster than diffusion, and
    a kernel that applies ``w(o)`` at ``-o`` computes something else.
    Divided by the sum and rounded to float32."""
    keys = _pairs(taps)
    pairs = list(dict.fromkeys(keys))
    mean = 0.5 + 0.5 * rng.random(len(pairs))
    odd = rng.uniform(-1.0, 1.0, len(pairs))
    m = np.array(pairs, dtype=np.float64).T  # (axes, pairs)
    odd -= m.T @ (np.linalg.pinv(m @ m.T) @ (m @ odd))
    odd[[i for i, p in enumerate(pairs) if not any(p)]] = 0.0
    big = np.abs(odd).max()
    if big > 1e-9:
        odd *= 0.5 * np.min(mean[np.abs(odd) > 1e-9]) / big
    else:
        odd[:] = 0.0
    index = {p: i for i, p in enumerate(pairs)}
    w = np.array([
        mean[index[k]] + (odd[index[k]] if tuple(o) == k else
                          -odd[index[k]])
        for o, k in zip(taps, keys)
    ])
    return [float(v) for v in (w / w.sum()).astype(np.float32)]


def per_tap_weights(taps, rng) -> list[float]:
    """One uniform draw in [0, 1) per tap, divided by their sum and rounded
    to float32: a random drift, which carries a field out through a zero
    wall at a rate that does not shrink with the grid."""
    w = rng.random(len(taps))
    return [float(v) for v in (w / w.sum()).astype(np.float32)]


WEIGHT_RULES = {"zero_drift": zero_drift_weights, "per_tap": per_tap_weights}


def inputs(config: dict, mix: dict, seed: int, device):
    """The cell's taps, its weights (the configuration's ``weight_rule``)
    and its blocks, uniform in [0, 1): all from ``seed``, the grids drawn
    on ``device`` in one call."""
    import torch

    op = config["operator"]
    taps = reference.offsets(op["kind"], int(op["radius"]), len(mix["grid"]))
    s = int(seed) % 2**64
    rule = WEIGHT_RULES[config["weight_rule"]]
    weights = rule(taps, np.random.default_rng(s))
    gen = torch.Generator(device=device)
    gen.manual_seed(s)
    dtype = getattr(torch, config["dtype"])
    grids = torch.rand(
        (int(mix["blocks"]), *map(int, mix["grid"])), generator=gen,
        device=device, dtype=dtype,
    )
    return taps, weights, list(grids.unbind(0))


def fresh_grids(config: dict, mix: dict, seed: int, device):
    """``fresh_calls`` grids of the mix's shape, uniform in [0, 1), from a
    stream of ``seed`` apart from the cell's inputs, one at a time."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + FRESH_STREAM) % 2**64)
    dtype = getattr(torch, config["dtype"])
    for _ in range(int(mix.get("fresh_calls", 2))):
        yield torch.rand(tuple(map(int, mix["grid"])), generator=gen,
                         device=device, dtype=dtype)


def port_entry(cell: dict, taps, weights, device):
    """The call the window drives: ``make(config, mix, taps, weights,
    device)`` of ``bench/entries/<entry>.py``, the mix's ``entry``."""
    config, mix = cell["config"], cell["mix"]
    path = Path(cell["root"]) / "bench" / "entries" / f"{mix['entry']}.py"
    if not path.exists():
        raise ValueError(f"unknown entry {mix['entry']!r}: no {path}")
    safe = mix["entry"].replace(".", "_").replace("-", "_")
    return _module(path, f"bench_entry_{safe}").make(
        config, mix, taps, weights, device)


def control_entry(cell: dict, taps, weights, device):
    """The reference in the program's place, computed in the
    configuration's ``check.control_dtype``: the precision one step below
    the configuration's own (the control of the check)."""
    import torch

    config = cell["config"]
    steps = int(cell["mix"]["time_steps"])
    dtype = getattr(torch, config["check"]["control_dtype"])
    bc = config.get("boundary", "zero")
    value = float(config.get("boundary_value", 0.0))
    return lambda u: reference.apply(u, taps, weights, steps, dtype,
                                     boundary=bc, value=value)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: dict, seed: int, seconds: float, traced: bool,
             device="cuda", entry=port_entry, t_start=None) -> dict:
    """Set up, run the closed loop for ``seconds``, check, and return the
    result line's dict (with ``checks`` last).  ``entry(cell, taps,
    weights, device)`` builds the call the window drives (the port's by
    default: the tests hand in a control or a broken one); ``t_start``,
    ``perf_counter`` seconds, is when set-up began (default: now)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    config, mix = cell["config"], cell["mix"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    phases = {"before_run_cell": time.perf_counter() - t_start}
    taps, weights, blocks = inputs(config, mix, seed, dev)
    _sync(dev)
    phases["inputs"] = time.perf_counter() - t_start - sum(phases.values())
    call = entry(cell, taps, weights, dev)
    calls_per_request = int(mix["calls_per_request"])
    steps = int(mix["time_steps"])
    order = [i % len(blocks) for i in range(calls_per_request)]

    def request(state, spans, sampled):
        """One request; ``sampled``, a call's position or ``None``, names
        the call whose input and output are handed back for the check."""
        pair = None
        t0 = time.perf_counter_ns()
        for pos, b in enumerate(order):
            c0 = time.perf_counter_ns()
            out = call(state[b])
            c1 = time.perf_counter_ns()
            if spans is not None:
                spans.append((c0, c1))
            if pos == sampled:
                pair = (state[b], out)
            state[b] = out
        s0 = time.perf_counter_ns()
        _sync(dev)
        return (t0, s0, time.perf_counter_ns()), pair

    request(blocks, None, None)  # the first: builds, plans, launch tables
    phases["first_request"] = (time.perf_counter() - t_start
                               - sum(phases.values()))
    for _ in range(WARM_REQUESTS - 1):  # every call signature it uses
        request(blocks, None, None)
    _sync(dev)
    phases["warm_requests"] = (time.perf_counter() - t_start
                               - sum(phases.values()))

    # The check's sample of the window: the first request's call and one
    # at each of ``checked_calls - 1`` times drawn from the seed, each at a
    # position among the first visits of a block (where the input is the
    # block's state as the request began).  Each sampled pair is copied to
    # the host after its request, with the window's clock paused, so that
    # neither the card's memory nor the window's time holds it.
    pick = np.random.default_rng([int(seed) % 2**64, 1])
    limit_ns = int(seconds * 1e9)
    marks = [0] + sorted(
        int(f * limit_ns) for f in pick.random(int(mix["checked_calls"]) - 1)
    )
    first_visits = min(len(order), len(blocks))
    kept: list = []
    holes: list = []  # (start, end) ns of the pauses

    prof = None
    if traced:
        prof = trace.start(on_card)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    clock_offset = trace.clock_offset_ns()
    requests: list = []
    calls: list = []
    t_open = time.perf_counter_ns()
    setup_s = time.perf_counter() - t_start
    paused = 0
    while time.perf_counter_ns() - t_open - paused < limit_ns:
        sampled = None
        if marks and marks[0] <= time.perf_counter_ns() - t_open - paused:
            marks.pop(0)
            sampled = int(pick.integers(first_visits))
        span, pair = request(blocks, calls, sampled)
        requests.append(span)
        if pair is not None:
            h0 = time.perf_counter_ns()
            kept.append(tuple(x.cpu() for x in pair))
            del pair
            h1 = time.perf_counter_ns()
            holes.append((h0, h1))
            paused += h1 - h0
    t_close = requests[-1][2]
    events = trace.stop(prof) if traced else None

    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    del blocks
    if on_card:
        torch.cuda.empty_cache()
    window_ns = t_close - t_open - sum(
        b - a for a, b in holes if b <= t_close)

    rec = {
        "config": config,
        "mix": mix,
        "setup_s": setup_s,
        "window_s": window_ns / 1e9,
        "requests": requests,
        "calls": calls,
        "points_per_call": int(np.prod([int(n) for n in mix["grid"]])),
        "steps_per_call": steps,
        "work": roofline.work(
            mix["grid"], len(taps), steps,
            getattr(torch, config["dtype"]).itemsize,
        ),
        "peak_bytes": peak,
        "trace": None,
    }
    if traced:
        host = sorted(
            [(c0 + clock_offset, c1 + clock_offset, "port_call")
             for c0, c1 in calls]
            + [(s0 + clock_offset, t1 + clock_offset, "synchronize")
               for _, s0, t1 in requests]
        )
        rec["trace"] = trace.summarize(
            events, t_open + clock_offset, t_close + clock_offset, host,
            holes=[(a + clock_offset, b + clock_offset) for a, b in holes],
        )

    # Calls on rough data: the same call object, after the window, on
    # fresh grids of the cell's shape, which no smoothing has evened out.
    fresh = []
    for u in fresh_grids(config, mix, seed, dev):
        out = call(u)
        _sync(dev)
        fresh.append((u, out))
    checks, scales = check(kept, fresh, taps, weights, steps, config, dev)
    correct = all(c["ok"] for c in checks.values())
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell[kind]:
        value = reader(m["name"], cell["root"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": peak if on_card else 0,
    }
    result = {
        "correct": correct,
        "attempted": len(requests),
        "failed": 0,
        "metrics": metrics,
        "device": device_info,
    }
    if traced and rec["trace"] is not None:
        device_info["busy_s"] = rec["trace"]["busy_s"]
        device_info["window_s"] = rec["window_s"]
        result["breakdown"] = trace.breakdown(rec["trace"])
    result["calls"] = len(calls)
    result["setup_phases_s"] = phases
    result["check_scales"] = scales
    result["checks"] = {
        k: {kk: v for kk, v in c.items() if kk != "ok"}
        for k, c in checks.items()
    }
    return result


def _rel_errs(pairs, taps, weights, steps, config, device):
    """Each pair's output against the float64 reference worked out from
    its input: the largest difference over every point, relative to the
    reference's largest magnitude (``inf`` for a NaN, a wrong shape or
    dtype), with that magnitude."""
    import torch

    bc = config.get("boundary", "zero")
    value = float(config.get("boundary_value", 0.0))
    errs, scales = [], []
    for u, out in pairs:
        if tuple(out.shape) != tuple(u.shape) or out.dtype != u.dtype:
            errs.append(float("inf"))
            continue
        u, out = u.to(device), out.to(device)
        ref = reference.apply(u, taps, weights, steps, torch.float64,
                              torch.float64, boundary=bc, value=value)
        scale = float(ref.abs().max())
        err = float((out.to(torch.float64) - ref).abs().max()) / (
            scale or 1.0)
        errs.append(err if np.isfinite(err) else float("inf"))
        scales.append(scale)
        del ref, u, out
    return errs, scales


def check(kept, fresh, taps, weights, steps, config, device="cpu"):
    """The check's numbers, each with its limit, and the references'
    largest magnitudes (the least, the most, and the worst call's).
    ``max_rel_err``: the largest relative difference over the window's
    sampled calls (relative, so that a field the zero boundary has
    drained is held as tightly as a fresh one); ``fresh_max_rel_err``:
    the same over the calls on fresh grids after the window (a call that
    returns its input, a stale output or mirrored taps reads large there
    however smooth the window's field has become); both held to the
    configuration's ``check.max_rel_err``; ``calls_checked``: the window's
    sampled calls (at least 1)."""
    limit = float(config["check"]["max_rel_err"])
    out = {}
    scales = {}
    for name, pairs in (("max_rel_err", kept), ("fresh_max_rel_err", fresh)):
        errs, mags = _rel_errs(pairs, taps, weights, steps, config, device)
        worst = max(errs, default=float("inf"))
        out[name] = {"value": worst if np.isfinite(worst) else "inf",
                     "limit": limit, "rule": "<=", "ok": worst <= limit}
        worst_at = (max(range(len(errs)), key=errs.__getitem__)
                    if errs and len(mags) == len(errs) else None)
        scales[name] = {
            "min": min(mags, default=None), "max": max(mags, default=None),
            "at_worst": None if worst_at is None else mags[worst_at],
        }
    out["calls_checked"] = {"value": len(kept), "limit": 1, "rule": ">=",
                            "ok": len(kept) >= 1}
    return out, scales


def check_lines(result: dict) -> list[str]:
    """The compared numbers beside their limits, one line each."""
    return [
        f"check {name} {c['value']!r} {c['rule']} {c['limit']!r}"
        for name, c in result["checks"].items()
    ]
