"""TunedPlanDB: the port's persistent measured-plan store, layered on the
PlanCache.

The PlanCache memoizes what the *model* decided; this DB records what the
*device* said.  One :class:`TuneRecord` per ``(request cache_key, backend
fingerprint)`` pair holds the measured timing of every candidate plan the
autotuner raced — median + IQR, modelled bytes and modelled ms, the
model-vs-measured ratio — plus the full frozen winner plan, so a warm hit
resolves to an executable :class:`~repro_torch.plan.schema.StencilPlan`
without re-measurement.

Keying: the *same* sha256 request keys as the PlanCache (a tuned entry
answers exactly one planning problem), additionally qualified by the
backend fingerprint (``repro_torch.plan.tune.backend_fingerprint``: the
device, torch and CUDA versions, and the hash of the kernels' sources),
so a CPU measurement is never served to the card or the reverse, and a
measurement taken before a kernel changed is never served after it.  A
fingerprint mismatch is a plain miss — the entry stays on disk for the
backend that wrote it.  The directory is the port's own:
``REPRO_TORCH_TUNED_DB_DIR``, else ``~/.cache/repro_torch/tuned`` (never
the JAX package's).

Versioning: :data:`TUNEDB_SCHEMA` guards the record layout and the
embedded plan is additionally checked against ``PLANNER_VERSION`` — a
bump of either invalidates stale entries (dropped and re-tuned, never
mis-parsed).

Robustness contract (inherited from the PlanCache): the DB can only ever
*miss*.  Corrupt or truncated entries are dropped and counted; an
unwritable directory logs one warning and degrades to memory-only.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
from collections import OrderedDict
from dataclasses import dataclass

from .. import obs
from .cache import _Stats
from .schema import PLANNER_VERSION, StencilPlan

__all__ = [
    "TUNEDB_SCHEMA",
    "CandidateTiming",
    "TuneRecord",
    "TunedPlanDB",
    "default_tuned_db_dir",
]

# v2: the §15 window/dtype race — every candidate row carries its
# ``window_kind``, its ``stage_dtypes``, and the ``advisory`` flag
# (numerics-changing dtype variants race for information, never for the
# win; a record whose winner is advisory is corrupt by construction).
# v1 records predate those columns and are dropped, re-tuned, never
# mis-compared against rows that raced a different variant space.
# (v1: the initial measured-plan record — candidate timing table, winner
# index, never-slower gate, embedded winner plan.  Bump to invalidate
# every stored measurement — they are re-taken, never mis-parsed.)
TUNEDB_SCHEMA = 2

_ENV_DIR = "REPRO_TORCH_TUNED_DB_DIR"

logger = logging.getLogger(__name__)


def default_tuned_db_dir() -> str:
    env = os.environ.get(_ENV_DIR)
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "tuned"
    )


@dataclass(frozen=True)
class CandidateTiming:
    """Measured cost of one candidate plan (all figures for the whole
    chain on the measured device; ``modeled_bytes`` is the candidate's
    total modelled device-memory traffic — per-shard bytes × shards + halo
    exchange — and ``modeled_ms`` its modelled time, the score the
    port's planner ranks candidates by)."""

    tile: tuple[int, ...]
    sweep_axis: int | None
    fused_depth: int
    shard_axis: int | None
    modeled_bytes: int
    median_s: float
    iqr_s: float
    reps: int
    achieved_gbps: float
    # (modeled_ms_c / modeled_ms_analytic) / (measured_c /
    # measured_analytic): 1.0 means the model predicted this candidate's
    # time relative to the analytic choice exactly; the spread of this
    # column is the model error the autotune loop exists to absorb.
    model_measured_ratio: float
    # §15 variant columns (schema v2): the frontier layout this row ran
    # under, the per-stage storage dtypes it raced (``None`` = the plain
    # input-dtype chain), and whether the row is advisory — measured for
    # information, ineligible to win (it computed different values).
    window_kind: str | None = None
    stage_dtypes: tuple | None = None
    advisory: bool = False
    modeled_ms: float = 0.0

    def to_dict(self) -> dict:
        return {
            "tile": list(self.tile),
            "sweep_axis": self.sweep_axis,
            "fused_depth": self.fused_depth,
            "shard_axis": self.shard_axis,
            "modeled_bytes": self.modeled_bytes,
            "median_s": self.median_s,
            "iqr_s": self.iqr_s,
            "reps": self.reps,
            "achieved_gbps": self.achieved_gbps,
            "model_measured_ratio": self.model_measured_ratio,
            "window_kind": self.window_kind,
            "stage_dtypes": (
                None if self.stage_dtypes is None
                else list(self.stage_dtypes)
            ),
            "advisory": self.advisory,
            "modeled_ms": self.modeled_ms,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CandidateTiming":
        dts = d.get("stage_dtypes")
        return cls(
            tile=tuple(int(t) for t in d["tile"]),
            sweep_axis=(
                None if d["sweep_axis"] is None else int(d["sweep_axis"])
            ),
            fused_depth=int(d["fused_depth"]),
            shard_axis=(
                None if d.get("shard_axis") is None else int(d["shard_axis"])
            ),
            modeled_bytes=int(d["modeled_bytes"]),
            median_s=float(d["median_s"]),
            iqr_s=float(d["iqr_s"]),
            reps=int(d["reps"]),
            achieved_gbps=float(d["achieved_gbps"]),
            model_measured_ratio=float(d["model_measured_ratio"]),
            window_kind=(
                None if d.get("window_kind") is None
                else str(d["window_kind"])
            ),
            stage_dtypes=(
                None if dts is None
                else tuple(None if t is None else str(t) for t in dts)
            ),
            advisory=bool(d.get("advisory", False)),
            modeled_ms=float(d["modeled_ms"]),
        )


@dataclass(frozen=True)
class TuneRecord:
    """One autotune run: every candidate's measured cost + the winner.

    ``winner``/``analytic`` index into ``candidates`` (the analytic entry
    is the planner's own argmin, always raced, so ``never_slower`` —
    measured winner time ≤ measured analytic time — holds by construction
    and is asserted at tune time).  ``rank_correlation`` is the Spearman
    correlation between modelled ms (the port's planner's score) and
    measured medians across the candidate set — the paper's Fig. 5-style
    model validation, per request.  ``winner_plan`` is the full frozen plan a warm DB hit
    serves."""

    key: str                          # PlanRequest.cache_key()
    fingerprint: str                  # backend/device identity at tune time
    candidates: tuple[CandidateTiming, ...]
    winner: int
    analytic: int
    never_slower: bool
    speedup_vs_analytic: float        # analytic median / winner median, >= 1
    rank_correlation: float
    winner_plan: StencilPlan
    tuned_at: str                     # ISO timestamp, informational
    schema: int = TUNEDB_SCHEMA
    planner_version: int = PLANNER_VERSION

    def to_dict(self) -> dict:
        return {
            "schema": self.schema,
            "planner_version": self.planner_version,
            "key": self.key,
            "fingerprint": self.fingerprint,
            "candidates": [c.to_dict() for c in self.candidates],
            "winner": self.winner,
            "analytic": self.analytic,
            "never_slower": self.never_slower,
            "speedup_vs_analytic": self.speedup_vs_analytic,
            "rank_correlation": self.rank_correlation,
            "winner_plan": self.winner_plan.to_dict(),
            "tuned_at": self.tuned_at,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TuneRecord":
        return cls(
            key=str(d["key"]),
            fingerprint=str(d["fingerprint"]),
            candidates=tuple(
                CandidateTiming.from_dict(c) for c in d["candidates"]
            ),
            winner=int(d["winner"]),
            analytic=int(d["analytic"]),
            never_slower=bool(d["never_slower"]),
            speedup_vs_analytic=float(d["speedup_vs_analytic"]),
            rank_correlation=float(d["rank_correlation"]),
            winner_plan=StencilPlan.from_dict(d["winner_plan"]),
            tuned_at=str(d["tuned_at"]),
            schema=int(d["schema"]),
            planner_version=int(d["planner_version"]),
        )


def _fp_tag(fingerprint: str) -> str:
    """Filesystem-safe 12-hex tag of a backend fingerprint."""
    return hashlib.sha256(fingerprint.encode()).hexdigest()[:12]


class TunedPlanDB:
    """Two-level measured-plan store: OrderedDict LRU in front of a JSON
    file dir, one file per ``(request key, backend fingerprint)``.

    ``persistent=False`` (or a directory that errors) degrades to
    memory-only — after the first disk error the directory is dropped and
    a single warning logged, so a broken cache dir costs one log line,
    not a stat per request.  ``stats`` mirrors the PlanCache counters
    plus ``fingerprint_misses`` (an entry existed but belonged to another
    backend — never served, never deleted).
    """

    def __init__(
        self,
        db_dir: str | None = None,
        capacity: int = 256,
        persistent: bool = True,
    ):
        self.capacity = int(capacity)
        self.dir = (db_dir or default_tuned_db_dir()) if persistent else None
        self._degraded = False
        self._mem: OrderedDict[tuple[str, str], TuneRecord] = OrderedDict()
        self.stats = _Stats(self, {
            "hits": 0,
            "misses": 0,
            "mem_hits": 0,
            "disk_hits": 0,
            "corrupt": 0,
            "stale_schema": 0,
            "fingerprint_misses": 0,
            "evictions": 0,
            "disk_errors": 0,
        })

    @property
    def degraded(self) -> bool:
        """True once a disk error dropped the directory (memory-only now)."""
        return self._degraded

    # -- internals ---------------------------------------------------------

    def _path(self, key: str, fingerprint: str) -> str:
        return os.path.join(self.dir, f"{key}.{_fp_tag(fingerprint)}.json")

    def _disable_disk(self, exc: BaseException) -> None:
        self.stats["disk_errors"] += 1
        if self.dir is not None:
            logger.warning(
                "tuned-plan DB dir %r unusable (%s: %s); degrading to "
                "in-memory-only for this process",
                self.dir, type(exc).__name__, exc,
            )
            self._degraded = True
            obs.add("tunedb_degrade")
            if obs.enabled():
                obs.event("tunedb_degrade", dir=self.dir,
                          error=f"{type(exc).__name__}: {exc}")
            self.dir = None

    def _remember(self, key: str, fingerprint: str, rec: TuneRecord) -> None:
        mk = (key, fingerprint)
        self._mem[mk] = rec
        self._mem.move_to_end(mk)
        while len(self._mem) > self.capacity:
            self._mem.popitem(last=False)
            self.stats["evictions"] += 1

    def _validate(self, rec: TuneRecord, key: str, fingerprint: str) -> bool:
        """True iff the record may be served for (key, fingerprint); raises
        on structural corruption, returns False on a clean fingerprint
        mismatch (someone else's measurement — a miss, not corruption)."""
        if rec.schema != TUNEDB_SCHEMA:
            self.stats["stale_schema"] += 1
            raise ValueError(
                f"tunedb schema {rec.schema} != {TUNEDB_SCHEMA}"
            )
        if rec.planner_version != PLANNER_VERSION:
            self.stats["stale_schema"] += 1
            raise ValueError(
                f"planner version {rec.planner_version} != {PLANNER_VERSION}"
            )
        if rec.key != key or rec.winner_plan.request.cache_key() != key:
            raise ValueError("tuned entry key mismatch")
        if not (0 <= rec.winner < len(rec.candidates)
                and 0 <= rec.analytic < len(rec.candidates)):
            raise ValueError("tuned entry indices out of range")
        if rec.candidates[rec.winner].advisory:
            raise ValueError(
                "tuned winner is an advisory (numerics-changing) row"
            )
        if rec.fingerprint != fingerprint:
            self.stats["fingerprint_misses"] += 1
            return False
        return True

    # -- API ---------------------------------------------------------------

    def get(self, key: str, fingerprint: str) -> TuneRecord | None:
        if obs.enabled():
            with obs.span("tunedb_lookup", key=key) as sp:
                rec = self._get(key, fingerprint)
                sp.set(outcome="hit" if rec is not None else "miss")
            obs.add("tunedb_hit" if rec is not None else "tunedb_miss")
            return rec
        return self._get(key, fingerprint)

    def _get(self, key: str, fingerprint: str) -> TuneRecord | None:
        mk = (key, fingerprint)
        rec = self._mem.get(mk)
        if rec is not None:
            self._mem.move_to_end(mk)
            self.stats["hits"] += 1
            self.stats["mem_hits"] += 1
            return rec
        obs.mark_cold()  # the open port call reads the disk or races
        if self.dir is not None:
            path = self._path(key, fingerprint)
            raw = None
            try:
                with open(path) as f:
                    raw = f.read()
            except FileNotFoundError:
                pass  # plain miss
            except OSError as e:
                self._disable_disk(e)
            if raw is not None:
                try:
                    rec = TuneRecord.from_dict(json.loads(raw))
                    served = self._validate(rec, key, fingerprint)
                except Exception:
                    # Corrupt/stale: drop it and fall back to re-tuning.
                    self.stats["corrupt"] += 1
                    try:
                        os.remove(path)
                    except OSError:
                        pass
                else:
                    if served:
                        self._remember(key, fingerprint, rec)
                        self.stats["hits"] += 1
                        self.stats["disk_hits"] += 1
                        return rec
        self.stats["misses"] += 1
        return None

    def put(self, rec: TuneRecord) -> None:
        self._remember(rec.key, rec.fingerprint, rec)
        if self.dir is None:
            return
        try:
            os.makedirs(self.dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(rec.to_dict(), f)
                os.replace(tmp, self._path(rec.key, rec.fingerprint))
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
