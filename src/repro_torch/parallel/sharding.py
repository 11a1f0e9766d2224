"""Parameter specs: a copy of ``ParamSpec`` from the JAX package's
``parallel/sharding``.

The logical axes ride along as data for the sharded model stack
(``ROADMAP.md`` queue A, item 12); nothing in the port reads them yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

__all__ = ["ParamSpec"]


@dataclass(frozen=True)
class ParamSpec:
    """Shape/dtype/logical-axes of one parameter leaf."""

    shape: tuple[int, ...]
    dtype: Any
    axes: tuple[str, ...]  # logical name per dim ('' = replicated)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")
