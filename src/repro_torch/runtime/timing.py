"""Measurement harness of the port: timing of torch callables, done right.

Every measured number of the tune loop (``repro_torch.plan.tune``) flows
through :func:`measure`, so the method is defined once:

* **warm-up excluded**: the first ``warmup`` calls run before the clock
  starts, so first-use costs (a kernel's launch tables, the allocator's
  first blocks) never land in the sample;
* **synchronized**: on the card each timed call sits between two CUDA
  events recorded on the current stream, with the device synchronized
  before the first and after the second.  The interval covers the host's
  preparation and the device's work, as the JAX package's wall clock
  around ``block_until_ready`` does;
* **median-of-n with IQR**: the reported statistic is the median of
  ``reps`` timed calls with the interquartile range as the noise bar.

The caller names the device (``None`` means ``"cuda"``, which raises
without CUDA, as every entry point of the port does): the clock follows
the device it is told, never what the machine happens to have.  On the
CPU (``device="cpu"``, the tests) the clock is ``time.perf_counter``.

:func:`device_fingerprint` is the identity of the thing being measured:
device kind, count and the torch/CUDA versions.  The ``TunedPlanDB`` keys
measurements by it (with the kernels' source hash on top) so numbers
taken on one device are never served to another.
"""

from __future__ import annotations

import platform
import time
from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from .. import obs, resolve_device

__all__ = ["TimingResult", "measure", "device_fingerprint"]


@dataclass(frozen=True)
class TimingResult:
    """Median-of-n sample of one callable (seconds)."""

    median_s: float
    iqr_s: float                      # q75 - q25 of the timed reps
    times_s: tuple[float, ...]        # every timed rep, in call order
    reps: int
    warmup: int

    @property
    def median_us(self) -> float:
        return self.median_s * 1e6

    @property
    def median_ms(self) -> float:
        return self.median_s * 1e3

    def to_dict(self) -> dict:
        return {
            "median_s": self.median_s,
            "iqr_s": self.iqr_s,
            "times_s": list(self.times_s),
            "reps": self.reps,
            "warmup": self.warmup,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TimingResult":
        return cls(
            median_s=float(d["median_s"]),
            iqr_s=float(d["iqr_s"]),
            times_s=tuple(float(t) for t in d["times_s"]),
            reps=int(d["reps"]),
            warmup=int(d["warmup"]),
        )


def _median_iqr(times: Sequence[float]) -> tuple[float, float]:
    xs = sorted(times)
    n = len(xs)
    mid = n // 2
    median = xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])

    def quantile(q: float) -> float:
        # Linear interpolation between closest ranks (numpy's default).
        pos = q * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        return xs[lo] + (pos - lo) * (xs[hi] - xs[lo])

    return median, quantile(0.75) - quantile(0.25)


def _timed_cuda(fn: Callable[[], object], dev: torch.device) -> float:
    """One call of ``fn`` between CUDA events on the current stream, the
    device idle before it and synchronized after it; seconds."""
    torch.cuda.synchronize(dev)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(dev):
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize(dev)
    return a.elapsed_time(b) / 1e3


def _timed_cpu(fn: Callable[[], object]) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def measure(
    fn: Callable[[], object],
    reps: int = 5,
    warmup: int = 1,
    device=None,
) -> TimingResult:
    """Time ``fn()`` on ``device`` (``None``: the card): ``warmup``
    un-timed calls, then ``reps`` timed calls, each synchronized, reported
    as median + IQR."""
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    if warmup < 0:
        raise ValueError(f"warmup must be >= 0, got {warmup}")
    dev = resolve_device(device)
    times: list[float] = []
    sp = obs.span("measure") if obs.enabled() else None
    if sp is not None:
        sp.__enter__()
    try:
        for _ in range(warmup):
            fn()
        if dev.type == "cuda":
            for _ in range(reps):
                times.append(_timed_cuda(fn, dev))
        else:
            for _ in range(reps):
                times.append(_timed_cpu(fn))
    finally:
        if sp is not None:
            measured_ns = int(sum(times) * 1e9) if times else 0
            sp.set(reps=reps, warmup=warmup, measured_ns=measured_ns,
                   device=dev.type)
            sp.__exit__(None, None, None)
            obs.add("measured_ns", measured_ns)
    median, iqr = _median_iqr(times)
    return TimingResult(
        median_s=median,
        iqr_s=iqr,
        times_s=tuple(times),
        reps=int(reps),
        warmup=int(warmup),
    )


_FINGERPRINTS: dict = {}


def device_fingerprint(device=None) -> str:
    """Stable identity of the device a measurement runs on:
    ``cuda:<device name>:xN:torch-<ver>:cuda-<ver>`` for the card,
    ``cpu:<machine>:x1:torch-<ver>`` for the plain versions.  Two
    processes with the same fingerprint measure the same hardware
    through the same stack — the precondition for sharing tuned-plan
    measurements."""
    dev = resolve_device(device)
    idx = dev.index if dev.type == "cuda" else None
    fp = _FINGERPRINTS.get((dev.type, idx))
    if fp is None:
        if dev.type == "cuda":
            i = idx if idx is not None else torch.cuda.current_device()
            name = torch.cuda.get_device_name(i).replace(" ", "_")
            fp = (f"cuda:{name}:x{torch.cuda.device_count()}:"
                  f"torch-{torch.__version__}:cuda-{torch.version.cuda}")
        else:
            machine = (platform.machine() or "unknown").replace(" ", "_")
            fp = f"cpu:{machine}:x1:torch-{torch.__version__}"
        _FINGERPRINTS[(dev.type, idx)] = fp
    return fp
