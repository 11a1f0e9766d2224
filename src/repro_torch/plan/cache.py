"""Content-addressed persistent plan cache (in-memory LRU + on-disk JSON).

The serving case plans the same (shape, stencil, budget) tuple millions of
times; a plan is pure data, so it is computed once and looked up ever
after.  Keys are ``PlanRequest.cache_key()`` — a sha256 over the canonical
request JSON plus the planner version — so they are stable across process
restarts and invalidate themselves when the pipeline changes.

Robustness contract: the cache can only ever *miss*.  A corrupted or
truncated on-disk entry, an unwritable cache dir, a permission error —
all degrade to re-planning, never to an exception reaching the caller.
A broken directory (anything beyond a plain entry-not-found) is dropped
after the *first* error — one logged warning, then in-memory-only for
the rest of the process — instead of re-stat-ing the dead path on every
request.

A copy of the JAX package's ``plan/cache`` with a directory of its own:
``REPRO_TORCH_PLAN_CACHE_DIR``, else ``~/.cache/repro_torch/plans`` (never
the reference's), so the two packages never read each other's plans.
With recording on (:mod:`repro_torch.obs`) a lookup is a
``plan_cache_lookup`` span and bumps ``plan_cache_hit`` or
``plan_cache_miss``; a degrade is a ``plan_cache_degrade`` event and
counter.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from collections import OrderedDict

from .. import obs
from .schema import PLANNER_VERSION, StencilPlan

__all__ = ["PlanCache", "default_cache_dir"]

_ENV_DIR = "REPRO_TORCH_PLAN_CACHE_DIR"

logger = logging.getLogger(__name__)


def default_cache_dir() -> str:
    env = os.environ.get(_ENV_DIR)
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "plans"
    )


class _Stats(dict):
    """Counter store that is both a dict and callable.

    ``cache.stats["misses"]`` keeps working everywhere it is used today;
    ``cache.stats()`` returns a snapshot that additionally reports the
    ``degraded`` flag (did a disk error drop the directory?), which is
    state, not a counter, and so has no natural dict slot."""

    def __init__(self, owner, counts: dict):
        super().__init__(counts)
        self._owner = owner

    def __call__(self) -> dict:
        snap = dict(self)
        snap["degraded"] = self._owner.degraded
        return snap


class PlanCache:
    """Two-level plan cache: OrderedDict LRU in front of a JSON file dir.

    ``persistent=False`` (or an unusable directory) degrades to
    memory-only.  ``stats`` counts hits/misses/disk activity so tests and
    benchmarks can assert cache behavior.
    """

    def __init__(
        self,
        cache_dir: str | None = None,
        capacity: int = 256,
        persistent: bool = True,
    ):
        self.capacity = int(capacity)
        self.dir = (cache_dir or default_cache_dir()) if persistent else None
        self._degraded = False
        self._mem: OrderedDict[str, StencilPlan] = OrderedDict()
        self.stats = _Stats(self, {
            "hits": 0,
            "misses": 0,
            "mem_hits": 0,
            "disk_hits": 0,
            "corrupt": 0,
            "evictions": 0,
            "disk_errors": 0,
        })

    @property
    def degraded(self) -> bool:
        """True once a disk error dropped the directory (memory-only now).
        ``persistent=False`` is a *choice*, not a degrade."""
        return self._degraded

    # -- internals ---------------------------------------------------------

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, f"{key}.json")

    def _disable_disk(self, exc: BaseException) -> None:
        """First disk error wins: log one warning, drop the directory, and
        serve memory-only from here on (a broken cache dir must cost one
        log line, not a failing stat per request)."""
        self.stats["disk_errors"] += 1
        if self.dir is not None:
            logger.warning(
                "plan cache dir %r unusable (%s: %s); degrading to "
                "in-memory-only for this process",
                self.dir, type(exc).__name__, exc,
            )
            self._degraded = True
            obs.add("plan_cache_degrade")
            if obs.enabled():
                obs.event("plan_cache_degrade", dir=self.dir,
                          error=f"{type(exc).__name__}: {exc}")
            self.dir = None

    def _remember(self, key: str, plan: StencilPlan) -> None:
        self._mem[key] = plan
        self._mem.move_to_end(key)
        while len(self._mem) > self.capacity:
            self._mem.popitem(last=False)
            self.stats["evictions"] += 1

    # -- API ---------------------------------------------------------------

    def get(self, key: str) -> StencilPlan | None:
        # The warm serving path stays sub-ms with recording off: one
        # predicate check, then straight to the lookup.
        if obs.enabled():
            with obs.span("plan_cache_lookup", key=key) as sp:
                plan = self._get(key)
                sp.set(outcome="hit" if plan is not None else "miss")
            obs.add("plan_cache_hit" if plan is not None
                    else "plan_cache_miss")
            return plan
        return self._get(key)

    def _get(self, key: str) -> StencilPlan | None:
        plan = self._mem.get(key)
        if plan is not None:
            self._mem.move_to_end(key)
            self.stats["hits"] += 1
            self.stats["mem_hits"] += 1
            return plan
        obs.mark_cold()  # the open port call reads the disk or plans
        if self.dir is not None:
            path = self._path(key)
            raw = None
            try:
                with open(path) as f:
                    raw = f.read()
            except FileNotFoundError:
                pass  # not on disk: plain miss, the directory is fine
            except OSError as e:
                self._disable_disk(e)  # broken dir: degrade once
            if raw is not None:
                try:
                    plan = StencilPlan.from_dict(json.loads(raw))
                    if plan.version != PLANNER_VERSION:
                        # A previous schema generation (e.g. a v2 entry
                        # predating stage chains): stale by definition.
                        raise ValueError(
                            f"planner version {plan.version} != "
                            f"{PLANNER_VERSION}"
                        )
                    if plan.request.cache_key() != key:
                        raise ValueError("cache key mismatch")
                except Exception:
                    # Corrupted entry: drop it and fall back to re-planning.
                    self.stats["corrupt"] += 1
                    try:
                        os.remove(path)
                    except OSError:
                        pass
                else:
                    self._remember(key, plan)
                    self.stats["hits"] += 1
                    self.stats["disk_hits"] += 1
                    return plan
        self.stats["misses"] += 1
        return None

    def put(self, key: str, plan: StencilPlan) -> None:
        self._remember(key, plan)
        if self.dir is None:
            return
        try:
            os.makedirs(self.dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(plan.to_dict(), f)
                os.replace(tmp, self._path(key))  # atomic publish
            except BaseException:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise
        except OSError as e:
            self._disable_disk(e)  # degrade to memory-only, log once

    def clear(self, disk: bool = False) -> None:
        self._mem.clear()
        if disk and self.dir is not None and os.path.isdir(self.dir):
            for name in os.listdir(self.dir):
                if name.endswith(".json"):
                    try:
                        os.remove(os.path.join(self.dir, name))
                    except OSError:
                        pass

    def __len__(self) -> int:
        return len(self._mem)
