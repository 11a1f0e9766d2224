"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``
/ ``list_archs()``, with the JAX package's names.

Each of the ten architectures has a module here with the published dims
and a ``smoke()`` reduced config of the same family for CPU tests; a
caller may register another config module under this package in
``sys.modules``, as the reference's ``examples/train_lm.py`` does.
"""

from __future__ import annotations

import importlib
import sys

from .base import LM_SHAPES, ModelCfg, MoECfg, ShapeCfg, SSMCfg  # noqa: F401

ARCHS = [
    "internvl2_2b",
    "whisper_large_v3",
    "zamba2_2p7b",
    "qwen1p5_32b",
    "granite_3_2b",
    "llama3_405b",
    "internlm2_20b",
    "mixtral_8x22b",
    "arctic_480b",
    "mamba2_2p7b",
]


def _norm(name: str) -> str:
    return name.replace("-", "_").replace(".", "p")


def _module(name: str):
    """The config module of ``name``: one of :data:`ARCHS`, or one a
    caller registered in ``sys.modules`` under this package (as
    ``examples/train_lm.py`` registers its 100M config)."""
    arch = _norm(name)
    full = f"{__name__}.{arch}"
    if arch not in ARCHS and full not in sys.modules:
        raise ValueError(f"unknown architecture {name!r}")
    return importlib.import_module(full)


def get_config(name: str) -> ModelCfg:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelCfg:
    return _module(name).smoke()


def list_archs() -> list[str]:
    return list(ARCHS)
