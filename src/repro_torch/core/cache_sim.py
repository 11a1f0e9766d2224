"""Exact set-associative LRU cache simulator (paper §2 model).

Simulates a (a, z, w) cache over a word-address stream and counts misses.
Direct-mapped (a=1) and 2-way LRU are fully vectorized; higher associativity
falls back to an exact per-set scan.  Used by the benchmarks to reproduce
the paper's Fig. 4 / Fig. 5 measurements without MIPS hardware counters.

Key facts used for vectorization (both exact):

* Sets are independent: the miss pattern of a set depends only on the
  subsequence of accesses mapping to that set.
* Removing *consecutive duplicate* line accesses within a set's subsequence
  removes only hits and does not perturb LRU state.
* After dedup, a 2-way LRU set holds exactly {t_{i-1}, t_{i-2}} before access
  i, so access i misses iff t_i != t_{i-2} (t_i != t_{i-1} by dedup).

A copy of the JAX package's ``core/cache_sim`` (numpy only),
held equal to it by ``tests/test_torch_paper_core.py``.
"""

from __future__ import annotations

import numpy as np

from .lattice import CacheGeometry

__all__ = ["simulate_misses", "simulate_loads", "MissReport"]


def _per_set_sequences(addr: np.ndarray, geom: CacheGeometry):
    """Stable-sort the stream by set; return (sorted line tags, set ids,
    group starts mask)."""
    line = addr // geom.w
    s = line % geom.z
    tag = line // geom.z
    perm = np.argsort(s, kind="stable")
    return tag[perm], s[perm]


def _dedup_within_groups(tag: np.ndarray, grp: np.ndarray):
    """Drop elements equal to their predecessor within the same group."""
    if len(tag) == 0:
        return tag, grp
    keep = np.ones(len(tag), dtype=bool)
    keep[1:] = (tag[1:] != tag[:-1]) | (grp[1:] != grp[:-1])
    return tag[keep], grp[keep]


def simulate_misses(addr: np.ndarray, geom: CacheGeometry) -> int:
    """Exact miss count of the LRU (a, z, w) cache on the address stream."""
    addr = np.asarray(addr, dtype=np.int64)
    tag, grp = _per_set_sequences(addr, geom)
    tag, grp = _dedup_within_groups(tag, grp)
    n = len(tag)
    if n == 0:
        return 0
    if geom.a == 1:
        # After dedup every remaining access within a group is a miss.
        return n
    if geom.a == 2:
        miss = np.ones(n, dtype=bool)
        if n > 2:
            same_grp2 = grp[2:] == grp[:-2]
            hit = same_grp2 & (tag[2:] == tag[:-2])
            miss[2:] = ~hit
        return int(miss.sum())
    # General a: exact per-set scan (slow path — only used in tests).
    return _scan_lru(tag, grp, geom.a)


def _scan_lru(tag: np.ndarray, grp: np.ndarray, a: int) -> int:
    misses = 0
    cur_grp = None
    lru: list[int] = []
    for t, g in zip(tag.tolist(), grp.tolist()):
        if g != cur_grp:
            cur_grp, lru = g, []
        if t in lru:
            lru.remove(t)
            lru.append(t)
        else:
            misses += 1
            lru.append(t)
            if len(lru) > a:
                lru.pop(0)
    return misses


def simulate_loads(addr: np.ndarray, geom: CacheGeometry) -> int:
    """Cache *loads* (word granularity, §2): misses of the same cache with
    w=1 — i.e. each distinct word fetch counts, matching the μ of the
    bounds sections."""
    g1 = CacheGeometry(a=geom.a, z=geom.z * geom.w, w=1)
    return simulate_misses(addr, g1)


class MissReport(dict):
    """Convenience: run one stream through the full and word-granular caches."""

    @classmethod
    def measure(cls, addr: np.ndarray, geom: CacheGeometry) -> "MissReport":
        return cls(
            misses=simulate_misses(addr, geom),
            loads=simulate_loads(addr, geom),
            accesses=int(len(addr)),
            geometry=(geom.a, geom.z, geom.w),
        )
