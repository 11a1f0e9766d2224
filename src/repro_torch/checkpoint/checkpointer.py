"""Checkpointing with async write + atomic commit, in the JAX package's
on-disk format.

Layout:  <dir>/step_<N>/
            manifest.json     — step, leaf paths, shapes, dtypes
            <leaf>.npy        — one file per tree leaf (full logical array)
         <dir>/LATEST         — atomically renamed pointer file

A leaf's path is the reference's: the keys (or sequence indices) from the
root joined by ``/`` (``0/embed/embedding``, ``0/layers/w_zx``,
``1/m/layers/ln``, ``1/count``), its file the path with ``/`` as ``__``.
The trainer saves the reference's trees (``convert.params_to_reference``
and ``convert.opt_state_to_reference``: layers stacked (L, ...)), so a
checkpoint written by either package restores in the other.

Properties (DESIGN.md §6):
  * atomic commit: a crash mid-write never corrupts LATEST (tmp dir +
    ``os.replace``);
  * async: the leaves are copied to host memory on the caller's thread,
    then written on a worker thread (``save(..., blocking=False)``), with
    :meth:`Checkpointer.wait` joining before the next save;
  * ``keep``: only the newest ``keep`` steps stay on disk.

A tree is nested dicts, tuples and lists of numpy arrays (the trainer's
tensors cross with ``convert``, which widens bf16 to float32);
:meth:`Checkpointer.restore` returns numpy arrays in the structure of
``tree_like``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

import numpy as np

__all__ = ["CheckpointConfig", "Checkpointer"]


@dataclass
class CheckpointConfig:
    directory: str
    keep: int = 3


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    """``{path: leaf}`` with the reference's paths (``jax``'s key paths:
    dict keys and sequence indices joined by ``/``)."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (tuple, list)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(tree_like, values: dict, prefix: str = ""):
    if isinstance(tree_like, dict):
        return {k: _unflatten(v, values, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree_like.items()}
    if isinstance(tree_like, (tuple, list)):
        return type(tree_like)(
            _unflatten(v, values, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(tree_like)
        )
    return values[prefix]


class Checkpointer:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        self.dir = Path(cfg.directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, blocking: bool = True):
        self.wait()
        host = {k: np.asarray(v) for k, v in _flatten(tree).items()}

        def _write():
            tmp = self.dir / f".tmp_step_{step}"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "leaves": {}}
            for key, leaf in host.items():
                fn = key.replace("/", "__") + ".npy"
                np.save(tmp / fn, leaf)
                manifest["leaves"][key] = {
                    "file": fn,
                    "shape": list(leaf.shape),
                    "dtype": str(leaf.dtype),
                }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)  # atomic commit
            latest_tmp = self.dir / ".LATEST.tmp"
            latest_tmp.write_text(str(step))
            os.replace(latest_tmp, self.dir / "LATEST")
            self._gc()

        def _write_async():
            try:
                _write()
            except Exception as e:  # re-raised by wait()
                self._error = e

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write_async, daemon=True)
            self._thread.start()

    def wait(self):
        """Join the pending async write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(
            int(p.name.split("_")[1])
            for p in self.dir.glob("step_*")
            if p.name.split("_")[1].isdigit()
        )
        for s in steps[: -self.cfg.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        f = self.dir / "LATEST"
        if not f.exists():
            return None
        return int(f.read_text().strip())

    def restore(self, tree_like, step: Optional[int] = None):
        """``(tree, step)``: the leaves of step ``step`` (default: LATEST)
        as numpy arrays, in the structure of ``tree_like``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        values = {
            key: np.load(d / manifest["leaves"][key]["file"])
            for key in _flatten(tree_like)
        }
        return _unflatten(tree_like, values), step
