"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``
/ ``list_archs()``, with the JAX package's names.

The SSM family (``mamba2_2p7b``) and the Zamba2 hybrid (``zamba2_2p7b``)
have a module here; the transformer families raise
``NotImplementedError`` naming the ``ROADMAP.md`` item that brings them.
"""

from __future__ import annotations

import importlib

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
PORTED = ("mamba2_2p7b", "zamba2_2p7b")
# The queue-A item of ROADMAP.md that brings each architecture not ported.
_LATER = {a: "item 7c (the transformer families)" for a in ARCHS
          if a not in PORTED}


def _norm(name: str) -> str:
    return name.replace("-", "_").replace(".", "p")


def _module(name: str):
    arch = _norm(name)
    if arch not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"{name} is not in the port yet: ROADMAP.md queue A, {_LATER[arch]}"
        )
    return importlib.import_module(f"{__name__}.{arch}")


def get_config(name: str) -> ModelCfg:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelCfg:
    return _module(name).smoke()


def list_archs() -> list[str]:
    return list(ARCHS)
