"""Deterministic, restart-safe token pipeline.

Two backends:
  * synthetic — seeded Zipf-ish token stream (CI / examples / dry-run);
  * memmap    — flat uint16/uint32 token file (production path), windowed
                without copying.

Determinism contract: batch ``i`` is a pure function of (seed, i) — so a
restarted job resumes from the checkpointed step with identical data, and
elastically re-scaled jobs re-shard the same global batch (DESIGN.md §6).
The per-host slice is ``global_batch[host_rank::host_count]`` — each host
materializes only its rows (on one host it is the whole batch).

A copy of the JAX package's ``data/pipeline.py``: it is numpy only, and
its batches equal the reference's bit for bit.  The trainer
(``launch/train.py``) moves each batch to the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    backend: str = "synthetic"          # 'synthetic' | 'memmap'
    path: Optional[str] = None          # token file for memmap
    dtype: str = "uint32"
    host_rank: int = 0
    host_count: int = 1


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.backend == "memmap":
            if not cfg.path:
                raise ValueError("memmap backend needs a token file")
            self._data = np.memmap(Path(cfg.path), dtype=cfg.dtype, mode="r")
            self._n_windows = (len(self._data) - 1) // cfg.seq_len
        else:
            self._data = None
            self._n_windows = 0

    # -- deterministic batch addressing ------------------------------------
    def _rows_for(self, step: int) -> np.ndarray:
        c = self.cfg
        return np.arange(c.host_rank, c.global_batch, c.host_count, dtype=np.int64) \
            + step * c.global_batch

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        c = self.cfg
        rows = self._rows_for(step)
        if c.backend == "memmap":
            idx = (rows * 2654435761 + c.seed) % max(self._n_windows, 1)
            toks = np.stack([
                self._data[i * c.seq_len : i * c.seq_len + c.seq_len + 1]
                .astype(np.int32)
                for i in idx
            ])
        else:
            toks = self._synthetic(rows)
        tokens = toks[:, :-1]
        targets = toks[:, 1:]
        mask = np.ones_like(targets, dtype=np.float32)
        return {"tokens": tokens, "targets": targets, "mask": mask}

    def _synthetic(self, rows: np.ndarray) -> np.ndarray:
        c = self.cfg
        out = np.empty((len(rows), c.seq_len + 1), dtype=np.int32)
        for j, r in enumerate(rows):
            rng = np.random.default_rng(np.uint64(c.seed * 1_000_003 + r))
            # Zipf-flavored ranks clipped to the vocab: cheap but non-uniform
            z = rng.zipf(1.3, size=c.seq_len + 1)
            out[j] = np.clip(z, 1, c.vocab - 1).astype(np.int32)
        return out

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
